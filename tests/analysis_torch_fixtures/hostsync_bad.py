"""Fixture: every host-sync class, on a per-step function's path.

Linted by tests/test_torch_analysis.py; never imported, never run."""

import torch

HOST_SYNC_ROOTS = ("bad_step", "store_step")


def _attend(scores, mask):
    fill = torch.tensor(-1e30, device=scores.device)
    return torch.where(mask, scores, fill)


def bad_step(x, table, pos):
    scale = float(x[0])
    if x.isnan().any():
        x = torch.zeros_like(x)
    ids = x.argmax(-1).tolist()
    host = x.cpu().numpy()
    step = int(pos)
    torch.cuda.synchronize()
    t = table.to(x.device)
    return _attend(x * scale, t > 0), ids, host, step, x.sum().item()


def store_step(ring, slot: int, pos: int):
    ring[slot] = pos
    ring[0] = 7
    return ring
