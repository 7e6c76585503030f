"""The port's checkpoint store (``nnstreamer_tpu_torch/core/checkpoint.py``)
held to the contracts of ``tests/test_checkpoint.py``'s store cases, run on
both packages: save, latest, restore and prune; a torn save is never
selected; an orphan marker is invisible and reclaimed; stray files leave
the newest step alone.  Selection and pruning must leave the same names in
both packages' directories, and the markers carry the same JSON.  A step
the JAX package wrote (orbax) is refused by the port's restore.

Tolerance: exact (restored tensors are bit-equal to what was saved).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import checkpoint as jckpt
from nnstreamer_tpu_torch.core import checkpoint as ckpt

torch.set_num_threads(2)


def _names(d):
    return sorted(n for n in os.listdir(d) if n.startswith("step_"))


def _state(step, pkg):
    w = np.arange(4.0, dtype=np.float32) + step
    if pkg is ckpt:
        return {"params": {"w": torch.from_numpy(w)}, "opt_state": {"m": torch.ones(4)}}
    return {"params": {"w": jnp.asarray(w)}, "opt_state": {"m": jnp.ones(4)}}


def test_save_latest_restore_prune(tmp_path):
    names = {}
    for pkg in (ckpt, jckpt):
        d = str(tmp_path / pkg.__name__)
        assert pkg.latest_step(d) is None
        for step in (1, 2, 3, 4):
            pkg.save_state(d, step, _state(step, pkg))
        assert pkg.latest_step(d) == 4
        pkg.prune(d, keep=2)
        names[pkg] = _names(d)
        assert pkg.latest_step(d) == 4
    assert names[ckpt] == names[jckpt] == ["step_3", "step_3.ok", "step_4", "step_4.ok"]
    restored = ckpt.restore_state(str(tmp_path / ckpt.__name__), 4)
    assert torch.equal(restored["params"]["w"], torch.arange(4.0) + 4)
    assert torch.equal(restored["opt_state"]["m"], torch.ones(4))


def test_torn_save_never_selected(tmp_path):
    """A crash between the state write and the completion marker (the
    torn-save window) leaves the previous durable step as the resume
    point, never the torn one; prune reclaims the torn dir."""
    metas = []
    for pkg in (ckpt, jckpt):
        d = str(tmp_path / pkg.__name__)
        zeros = torch.zeros(2) if pkg is ckpt else jnp.zeros(2)
        ones = torch.ones(2) if pkg is ckpt else jnp.ones(2)
        pkg.save_state(d, 1, {"w": zeros}, meta={"cursor": {"step": 1}})
        pkg.write_state(d, 2, {"w": ones})  # no commit: torn
        assert os.path.isdir(os.path.join(d, "step_2"))
        assert pkg.latest_step(d) == 1
        metas.append(pkg.load_meta(d, 1))
        pkg.prune(d, keep=3)
        assert not os.path.exists(os.path.join(d, "step_2"))
        assert pkg.latest_step(d) == 1
    assert metas[0] == metas[1] == {"cursor": {"step": 1}, "step": 1}
    with open(os.path.join(tmp_path / ckpt.__name__, "step_1.ok"), "rb") as a, \
            open(os.path.join(tmp_path / jckpt.__name__, "step_1.ok"), "rb") as b:
        assert a.read() == b.read()  # the marker format is the JAX package's


def test_orphan_marker_never_selected(tmp_path):
    """A marker without its step dir (half-pruned by a crash) is
    invisible to latest_step and reclaimed by prune."""
    for pkg in (ckpt, jckpt):
        d = str(tmp_path / pkg.__name__)
        pkg.save_state(d, 1, {"w": torch.zeros(2) if pkg is ckpt else jnp.zeros(2)})
        pkg.commit_state(d, 5, {})  # orphan: no step_5 dir
        assert pkg.latest_step(d) == 1
        pkg.prune(d, keep=3)
        assert not os.path.exists(os.path.join(d, "step_5.ok"))
        assert _names(d) == ["step_1", "step_1.ok"]


def test_prune_ignores_stray_files(tmp_path):
    for pkg in (ckpt, jckpt):
        d = str(tmp_path / pkg.__name__)
        for step in (1, 2):
            pkg.save_state(d, step, {"w": torch.zeros(2) if pkg is ckpt else jnp.zeros(2)})
        open(os.path.join(d, "step_9"), "w").close()  # stray regular file
        pkg.prune(d, keep=1)
        assert pkg.latest_step(d) == 2  # real newest survives
        assert _names(d) == ["step_2", "step_2.ok", "step_9"]


def test_a_jax_orbax_step_is_refused(tmp_path):
    """The JAX package's committed orbax step is selected by the shared
    marker protocol but never read as the port's state."""
    d = str(tmp_path / "ck")
    jckpt.save_state(d, 3, {"w": jnp.zeros(2)}, meta={"cursor": {"step": 3}})
    assert ckpt.latest_step(d) == 3
    assert ckpt.load_meta(d, 3) == {"cursor": {"step": 3}, "step": 3}
    with pytest.raises(ValueError, match="orbax checkpoint written by the JAX package"):
        ckpt.restore_state(d, 3)
    os.makedirs(os.path.join(d, "step_4"))
    ckpt.commit_state(d, 4)
    with pytest.raises(FileNotFoundError, match="no state.pt"):
        ckpt.restore_state(d, 4)


def test_state_is_weights_only_loadable_and_atomic(tmp_path):
    """A trainer-shaped state (a state_dict and torch.optim's state)
    round-trips through ``weights_only`` loading; the write leaves no
    temporary file behind."""
    module = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(module.parameters(), lr=1e-3)
    module(torch.ones(1, 3)).sum().backward()
    opt.step()
    d = str(tmp_path / "ck")
    ckpt.save_state(d, 7, {"params": module.state_dict(), "opt_state": opt.state_dict()})
    assert sorted(os.listdir(os.path.join(d, "step_7"))) == ["state.pt"]
    got = ckpt.restore_state(d, 7)
    for k, v in module.state_dict().items():
        assert torch.equal(got["params"][k], v)
    opt2 = torch.optim.Adam(torch.nn.Linear(3, 2).parameters(), lr=1e-3)
    opt2.load_state_dict(got["opt_state"])
    assert json.dumps(opt2.state_dict()["param_groups"]) == json.dumps(
        opt.state_dict()["param_groups"])
