"""The ensemble engine's chunk schedule against the JAX package's.

``repro_torch.train.schedule`` is a pure-Python copy of
``repro.train.schedule``: the same chunks, field for field, for every
mixing kind (and a mixing window), run length, record period and with
gate-run splitting on and off; the record and chunk edges; the pipeline
helpers and their errors; and the engine's staging gate.
"""

import dataclasses

import pytest

from repro.core import mixing as jmix
from repro.train import schedule as jsched

from repro_torch.core import mixing as mix
from repro_torch.train import engine
from repro_torch.train import schedule as sched

KINDS = {
    "wash": dict(kind="wash", mode="bucketed"),
    "papa": dict(kind="papa", papa_every=3),
    "papa_all": dict(kind="papa_all", papa_all_every=4),
    "none": dict(kind="none"),
    "window": dict(kind="wash", mode="bucketed", start_step=4, stop_step=9),
}


def _fields(schedule):
    return ([dataclasses.astuple(c) for c in schedule.chunks],
            schedule.mix_pad_len, schedule.nomix_pad_len,
            schedule.variants(), schedule.num_padded_steps(),
            [(c.length, c.pad, list(c.steps), c.padded_gates(),
              c.padded_valid()) for c in schedule.chunks])


@pytest.mark.parametrize("split", [True, False], ids=["split", "nosplit"])
@pytest.mark.parametrize("every", [1, 5, 25])
@pytest.mark.parametrize("total", [1, 7, 25, 26])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_build_schedule_is_the_reference_field_for_field(kind, total, every,
                                                         split):
    got = sched.build_schedule(total, every, mix.MixingConfig(**KINDS[kind]),
                               split_gate_runs=split)
    want = jsched.build_schedule(total, every,
                                 jmix.MixingConfig(**KINDS[kind]),
                                 split_gate_runs=split)
    assert _fields(got) == _fields(want)
    assert len(got.variants()) <= 2


def test_record_boundaries_and_chunk_ranges_at_their_edges():
    for total, every in [(1, 25), (5, 1), (3, 10), (25, 25), (26, 25),
                         (50, 7)]:
        assert (sched.record_boundaries(total, every)
                == jsched.record_boundaries(total, every))
        assert (sched.chunk_ranges(total, every)
                == jsched.chunk_ranges(total, every))
    assert sched.record_boundaries(1, 25) == [0]
    assert sched.record_boundaries(3, 10) == [0, 2]
    assert sched.chunk_ranges(3, 10) == [(0, 1), (1, 3)]
    assert sched.chunk_ranges(26, 25) == [(0, 1), (1, 26)]
    assert sched.chunk_ranges(0, 5) == []


def test_pipeline_helpers_and_their_errors():
    for m, s in [(1, 1), (4, 2), (8, 4)]:
        assert (sched.num_pipeline_ticks(m, s)
                == jsched.num_pipeline_ticks(m, s) == m + s - 1)
    for b, m in [(8, 1), (8, 4), (6, 3)]:
        assert (sched.split_microbatch_sizes(b, m)
                == jsched.split_microbatch_sizes(b, m) == (m, b // m))
    for m, s in [(0, 1), (1, 0), (-1, 2)]:
        with pytest.raises(ValueError, match="num_micro"):
            sched.num_pipeline_ticks(m, s)
    for b, m in [(8, 3), (8, 0), (4, -1)]:
        with pytest.raises(ValueError, match="microbatches"):
            sched.split_microbatch_sizes(b, m)


def test_resolve_async_staging():
    wash = mix.MixingConfig(kind="wash", mode="bucketed")
    one = sched.build_schedule(5, 25, wash).chunks[1:]       # one chunk
    long_ = sched.build_schedule(26, 5, wash).chunks          # avg > 2
    short = sched.build_schedule(5, 1, wash).chunks           # avg 1
    assert len(one) == 1 and len(short) == 5
    for chunks in (one, long_, short):
        for dev in ("cpu", "cuda"):
            assert engine.resolve_async_staging(True, chunks, dev) is True
            assert engine.resolve_async_staging(False, chunks, dev) is False
    assert engine.resolve_async_staging(None, one, "cuda") is False
    assert engine.resolve_async_staging(None, long_, "cuda") is True
    assert engine.resolve_async_staging(None, short, "cuda") is True
    assert engine.resolve_async_staging(None, long_, "cpu") is True
    assert engine.resolve_async_staging(None, short, "cpu") is False
    assert engine.ASYNC_STAGING_MIN_CHUNK_STEPS == 2
