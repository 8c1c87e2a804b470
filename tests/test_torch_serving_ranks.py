"""Stage-split and data-mesh serving on 4 ``gloo`` ranks, held bitwise to
the port at world 1.

One spawn of 4 ranks (``tests/torch_ring_worker.py``'s ``serving``
scenario, a ``FileStore`` under ``tmp_path``, one 120 s deadline); here,
in the parent, the same requests run at world 1 (the unstaged engine is
held to JAX's in ``tests/test_torch_engine.py``, the stage functions in
``tests/test_torch_staged_serving.py``):

  * stage-split serving over 4 stages and over 2 (the rank pairs [0, 1]
    and [2, 3], whose stages are not their global ranks), GQA and MLA,
    greedy and at temperature 0.8: every stage's tokens equal world 1's;
    two same-shape requests build one program pair, reported as
    ``compile.serve_prefill_staged`` and ``compile.serve_decode_staged``;
  * the data mesh of 4: B = 8 split (2 rows a rank) and B = 6 replicated,
    soup and ensemble, greedy and sampled, every rank's whole output
    equal to world 1's, and each rank's rows equal to world 1 serving
    those rows alone (the same per-rank batch); a global-MoE config is
    served replicated;
  * an ensemble-engine ``TrainResult`` of N = 4 on a pair of ranks (two
    members a rank) gives world 1's soup, members and ensemble through
    ``serving_params`` / ``averaged_params`` on every rank, where the
    soup of the rank's own block differs;
  * the serve CLI under ``--pp-stages 4`` (drawn, and restored from a
    population file onto each stage) and ``--mesh data`` serves world
    1's tokens.
"""

import numpy as np
import pytest
import torch

import torch_ring_worker as W
from repro_torch.launch import serve
from repro_torch.core.prng import fold_in
from repro_torch.serving import engine
from repro_torch.train import checkpoint

RANKS = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and world 1's, computed here while they run."""
    path = tmp_path_factory.mktemp("serving")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = W.sv_cli_cfg()
        ckpt = checkpoint.save(str(path / "sv_pop"), serve.init_population(
            cfg, 2, 0, "cpu"))
        wait = W.start("serving", RANKS, str(path),
                       {"ckpt": np.asarray(ckpt)})
        world1 = {tag: W.sv_generate(name, 4, "soup", temp).numpy()
                  for tag, name, _, temp in W.SV_RUNS}
        for tag, name, batch, mode, temp in W.SV_DATA:
            world1[tag] = W.sv_generate(name, batch, mode, temp).numpy()
            if batch % RANKS == 0:
                rows = batch // RANKS
                for r in range(RANKS):
                    sl = slice(r * rows, (r + 1) * rows)
                    seeds = ([fold_in(W.SV_SEED, b)
                              for b in range(batch)][sl] if temp > 0
                             else None)
                    world1[f"{tag}/rows{r}"] = W.sv_generate(
                        name, batch, mode, temp, seeds=seeds,
                        rows=sl).numpy()
        res = W.toy_train(dict(kind="wash", base_p=0.5, mode="bucketed"))
        for what, params in (
                ("soup", engine.serving_params(res, "soup")),
                ("member3", engine.serving_params(res, "member", 3)),
                ("ens", engine.serving_params(res, "ensemble"))):
            world1.update(W.flat_tree(params, f"{what}/"))
        world1["cli"] = serve.main(W.SV_CLI, cfg=cfg)["soup"]["tokens"]
        world1["cli_ckpt"] = serve.main(W.SV_CLI + ["--ckpt", ckpt],
                                        cfg=cfg)["soup"]["tokens"]
        return world1, wait()
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("tag", [t for t, *_ in W.SV_RUNS])
def test_staged_tokens_equal_world_one(runs, tag):
    world1, outs = runs
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out[tag], world1[tag], err_msg=r)


def test_one_program_pair_serves_two_same_shape_requests(runs):
    _, outs = runs
    for out in outs:  # programs built, cached, and their compile events
        assert out["programs"].tolist() == [1, 1, 1, 1, 1, 0, 0]


@pytest.mark.parametrize("tag", [t for t, *_ in W.SV_DATA])
def test_data_mesh_tokens_equal_world_one(runs, tag):
    world1, outs = runs
    batch = {t: b for t, _, b, *_ in W.SV_DATA}[tag]
    want = ("replicated" if batch % RANKS or tag.endswith("moe")
            else "split")
    for r, out in enumerate(outs):
        assert out[f"{tag}/layout"].item() == want
        np.testing.assert_array_equal(out[tag], world1[tag], err_msg=r)
        if want == "split":  # each rank's rows at its own batch size
            rows = batch // RANKS
            np.testing.assert_array_equal(
                out[tag][r * rows:(r + 1) * rows], world1[f"{tag}/rows{r}"],
                err_msg=r)


def test_an_engine_result_serves_the_whole_population(runs):
    world1, outs = runs
    keys = [k for k in world1 if k.split("/")[0] in ("soup", "member3",
                                                     "ens")]
    assert len(keys) == 9
    for r, out in enumerate(outs):
        for k in keys:
            np.testing.assert_array_equal(out[k], world1[k].numpy(),
                                          err_msg=(r, k))
        for k in [k for k in keys if k.startswith("soup/")]:
            np.testing.assert_array_equal(
                out["averaged/" + k[5:]], world1[k].numpy(), err_msg=(r, k))
        # the soup of this rank's own block is not the population's
        assert any(not np.array_equal(out["block_soup/" + k[5:]],
                                      world1[k].numpy())
                   for k in keys if k.startswith("soup/"))


@pytest.mark.parametrize("tag, want", [("cli_pp4", "cli"),
                                       ("cli_pp4_ckpt", "cli_ckpt"),
                                       ("cli_data", "cli")])
def test_serve_cli_over_ranks_serves_world_one_tokens(runs, tag, want):
    world1, outs = runs
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out[tag], world1[want].numpy(),
                                      err_msg=r)
