"""Port parity: the time-synchronization policies (``core/sync.py``:
``SyncPolicy`` and ``Collator``; nosync, slowest, basepad, refresh)
against the JAX package's, on the CPU.

Every scenario drives the JAX collator and the port's with the same pushes,
EOS marks and collects.  The emitted sets (values and pts per pad), the
``None`` answers and ``all_eos`` must be equal.  Each scenario also holds
the port to the contract that ``tests/test_core_sync.py`` pins.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import sync as jax_sync
from nnstreamer_tpu.core.buffer import TensorFrame as JaxFrame
from nnstreamer_tpu_torch.core import sync
from nnstreamer_tpu_torch.core.buffer import TensorFrame

torch.set_num_threads(2)


def _drive(mod, frame_cls, policy, script, pads=2):
    """Run `script` (("push", pad, value, pts) | ("eos", pad) |
    ("collect",) | ("drain",) | ("all_eos",)) on one package's collator;
    returns what each step answered."""
    c = mod.Collator(pads, mod.SyncPolicy.from_string(*policy))
    out = []

    def sets(got):
        return None if got is None else [(int(f.tensors[0][0]), f.pts) for f in got]

    for step in script:
        if step[0] == "push":
            c.push(step[1], frame_cls([np.array([step[2]], np.int32)], pts=step[3]))
        elif step[0] == "eos":
            c.mark_eos(step[1])
        elif step[0] == "collect":
            out.append(sets(c.collect()))
        elif step[0] == "drain":
            while (got := c.collect()) is not None:
                out.append(sets(got))
        else:
            out.append(c.all_eos)
    return out


def both(policy, script, pads=2):
    want = _drive(jax_sync, JaxFrame, policy, script, pads)
    got = _drive(sync, TensorFrame, policy, script, pads)
    assert got == want
    return got


def vals(answer):
    return None if answer is None else [v for v, _ in answer]


def test_nosync_pairs_in_arrival_order():
    got = both(("nosync",), [("collect",), ("push", 0, 1, 0.0), ("collect",),
                             ("push", 1, 10, 5.0), ("collect",)])
    assert got[:2] == [None, None] and vals(got[2]) == [1, 10]


def test_nosync_eos_pad_repeats_last():
    got = both(("nosync",), [("push", 0, 1, 0.0), ("push", 1, 10, 0.0), ("collect",),
                             ("eos", 1), ("push", 0, 2, 1.0), ("collect",)])
    assert vals(got[1]) == [2, 10]


def test_slowest_fast_pad_drops_to_base():
    got = both(("slowest",), [("push", 0, 0, 0.0), ("push", 0, 1, 0.033), ("push", 0, 2, 0.066),
                              ("push", 1, 100, 0.066), ("collect",)])
    assert vals(got[0]) == [2, 100]


def test_slowest_not_ready_until_all_pads():
    assert both(("slowest",), [("push", 0, 0, 0.0), ("collect",)]) == [None]


def test_slowest_incremental_arrival_waits_for_fresh_frame():
    got = both(("slowest",), [("push", 0, 0, 0.0), ("push", 1, 100, 0.2), ("collect",),
                              ("push", 0, 1, 0.1), ("collect",), ("push", 0, 2, 0.2),
                              ("collect",)])
    assert got[:2] == [None, None] and vals(got[2]) == [2, 100]


def test_slowest_phase_offset_streams_emit_continuously():
    script = []
    for k in range(50):
        script += [("push", 0, k, k * 0.033), ("push", 1, 100 + k, k * 0.033 + 0.015), ("drain",)]
    got = both(("slowest",), script)
    assert len(got) >= 45
    assert all(abs(a - (b - 100)) <= 1 for a, b in map(vals, got))


def test_basepad_base_drives_output():
    got = both(("basepad", "0:1.0"), [("push", 1, 10, 0.0), ("push", 0, 1, 0.1), ("collect",),
                                      ("push", 0, 2, 0.2), ("collect",)])
    assert [vals(g) for g in got] == [[1, 10], [2, 10]]


def test_basepad_waits_for_other_pad_first_frame():
    assert both(("basepad", "0:1.0"), [("push", 0, 1, 0.0), ("collect",)]) == [None]


def test_basepad_zero_window_is_strict():
    for mod in (jax_sync, sync):
        assert mod.SyncPolicy.from_string("basepad", "0:0").window == 0.0
        assert mod.SyncPolicy.from_string("basepad", "0").window is None
    got = both(("basepad", "0:0"), [("push", 0, 1, 0.0), ("push", 1, 10, 0.0), ("collect",),
                                    ("push", 0, 2, 0.1), ("push", 1, 11, 99.0), ("collect",)])
    assert [vals(g) for g in got] == [[1, 10], [2, 10]]


def test_refresh_any_new_frame_triggers():
    got = both(("refresh",), [("push", 0, 1, 0.0), ("collect",), ("push", 1, 10, 0.0),
                              ("collect",), ("push", 0, 2, 1.0), ("collect",), ("collect",)])
    assert [vals(g) for g in got] == [None, [1, 10], [2, 10], None]


@pytest.mark.parametrize("policy,eos_pads,want", [
    (("nosync",), [0], False), (("nosync",), [0, 1], True),
    (("slowest",), [0], True),
    (("basepad", "0:1.0"), [1], False), (("basepad", "0:1.0"), [1, 0], True),
    (("refresh",), [1], False),
], ids=["nosync-one", "nosync-all", "slowest", "basepad-other", "basepad-base", "refresh"])
def test_all_eos_per_policy(policy, eos_pads, want):
    assert both(policy, [("eos", p) for p in eos_pads] + [("all_eos",)]) == [want]


@pytest.mark.parametrize("mode", ["nosync", "slowest", "basepad", "refresh"])
def test_seeded_random_streams(mode):
    """Three pads of seeded jittered pts, pushed interleaved with collects
    and EOS: the same emitted sets in both packages."""
    rng = np.random.default_rng(3)
    script, t = [], np.zeros(3)
    for k in range(60):
        pad = int(rng.integers(0, 3))
        t[pad] += float(rng.uniform(0.01, 0.05))
        script.append(("push", pad, k, round(float(t[pad]), 4)))
        if rng.random() < 0.4:
            script.append(("drain",))
    script += [("eos", 2), ("drain",), ("eos", 0), ("eos", 1), ("drain",), ("all_eos",)]
    policy = (mode, "1:0.02") if mode == "basepad" else (mode,)
    assert len(both(policy, script, pads=3)) > 1


def test_unknown_mode_rejected():
    for mod in (jax_sync, sync):
        with pytest.raises(ValueError, match="unknown sync mode"):
            mod.SyncPolicy.from_string("sometimes")
        with pytest.raises(ValueError, match="at least one pad"):
            mod.Collator(0, mod.SyncPolicy())
