"""Fixture: the exempt look-alikes of every host-sync rule.

Shape / ndim / numel / len metadata through int() / float() / bool(),
constants, scalars handed to torch ops as Python numbers, a device
tensor made on the device, and host conversions outside any step."""

import torch

HOST_SYNC_ROOTS = ("good_step", "store_step")


def _attend(scores, mask):
    return torch.where(mask, scores, -1e30)


def good_step(x, mask):
    b = int(x.shape[0])
    rank = float(x.ndim)
    n = int(x.numel()) + len(mask)
    flag = bool(0)
    pos = torch.full((b,), 3, device=x.device)
    if any(d > 1 for d in x.shape):
        x = x * rank
    return _attend(x + pos[:, None] + n, mask), flag


def host_side(x):
    # not reached from a step: a host read is the point here
    return float(x.sum().item())


def store_step(ring, values, slot: int):
    # a tensor stored by index, and a host scalar filled by a kernel
    ring[slot] = values[0]
    ring.narrow(0, slot, 1).fill_(3)
    return ring
