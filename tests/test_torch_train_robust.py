"""Crash-safe in-pipeline training in the port: the contracts of
``tests/test_train_robust.py:82-425`` on ``framework=torch
accelerator=cpu``.

* the kill/resume truth table: a fault before the checkpoint write, in
  the torn-save gap, and on a train step after a durable checkpoint;
  resume lands on the newest durable step, retrains nothing, and ends
  bit-identical (exact equality of every weight and optimizer tensor) to
  an uninterrupted run; each row's durable step and replay skip are the
  JAX package's;
* supervision: a dead training thread surfaces on a quiet stream, and
  ``error-policy=restart`` revives the backend, resumes and realigns;
* the memory watermark pauses training (frozen, counted) and training
  finishes with zero sample loss;
* a truncated repo trains on its complete prefix, counted, with the
  same health numbers as the JAX pipeline.

The validator's gate (``TestValidatorGate``) waits for ``model_validator``
(ROADMAP A9.2).
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core.resilience import FAULTS as JAX_FAULTS
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.core import checkpoint as ckpt
from nnstreamer_tpu_torch.core.buffer import TensorFrame
from nnstreamer_tpu_torch.core.resilience import FAULTS, TransientError
from nnstreamer_tpu_torch.pipeline import parse_pipeline
from nnstreamer_tpu_torch.pipeline.element import ElementError
from nnstreamer_tpu_torch.trainer.torch_trainer import TorchTrainer

torch.set_num_threads(2)

N, B, CLASSES = 16, 8, 4           # 2 optimizer steps per epoch
STEPS_PER_EPOCH = N // B
CFG = {
    "arch": "mnist_cnn", "arch_props": {"classes": str(CLASSES)},
    "optimizer": "adam", "learning_rate": 3e-3,
    "batch_size": B, "loss": "softmax_ce",
}
TRAINER = f"tensor_trainer name=train accelerator=cpu num-inputs=1 num-labels=1 num-training-samples={N}"


@pytest.fixture(autouse=True)
def _reset_faults():
    yield
    FAULTS.reset()
    JAX_FAULTS.reset()


def _make_frames(n=N, seed=0):
    """Deterministic learnable banded images (class = bright band)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        label = i % CLASSES
        img = rng.normal(0.2, 0.05, (28, 28, 1)).astype(np.float32)
        img[label * 5 : label * 5 + 4, :, :] += 0.8
        out.append((img, np.int32([label])))
    return out


def _write_repo(dirpath, frames, claim=None, truncate_bytes=0):
    """Flat-binary datarepo + meta (the datareposink layout), directly."""
    data_path = os.path.join(dirpath, "data.bin")
    json_path = os.path.join(dirpath, "data.json")
    blob = b"".join(img.tobytes() + lab.tobytes() for img, lab in frames)
    if truncate_bytes:
        blob = blob[:-truncate_bytes]
    with open(data_path, "wb") as f:
        f.write(blob)
    sample_size = frames[0][0].nbytes + frames[0][1].nbytes
    with open(json_path, "w") as f:
        json.dump({
            "tensors": ["float32:1:28:28", "int32:1"],  # innermost-first dims
            "total_samples": claim or len(frames),
            "sample_size": sample_size,
        }, f)
    return data_path, json_path


def _leaves(tree):
    """Every tensor of a state tree, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return []


# ---------------------------------------------------------------------------
# Kill/resume truth table (backend grain)
# ---------------------------------------------------------------------------
class TestKillResumeTruthTable:
    EPOCHS = 2

    def _run(self, ck_dir, frames, resume=False):
        tr = TorchTrainer()
        tr.create({
            "model-config": json.dumps(CFG), "num-inputs": 1, "accelerator": "cpu",
            "num-labels": 1, "num-training-samples": N,
            "num-validation-samples": 0, "epochs": self.EPOCHS,
            "checkpoint-path": ck_dir, "checkpoint-interval": 1,
            "checkpoint-keep": 0, "resume": resume,
        })
        tr.start()
        for ep in range(self.EPOCHS):
            for i in range(N):
                fr = TensorFrame([frames[i][0], frames[i][1]])
                fr.meta["epoch"] = ep
                fr.meta["sample_index"] = i
                tr.push_data(fr)
        tr.end_of_data()
        tr._thread.join(timeout=300)
        assert not tr._thread.is_alive()
        return tr

    @pytest.fixture(scope="class")
    def control(self, tmp_path_factory):
        frames = _make_frames()
        ck_dir = str(tmp_path_factory.mktemp("ctl") / "ck")
        tr = self._run(ck_dir, frames)
        assert tr.error is None and ckpt.latest_step(ck_dir) == self.EPOCHS
        return frames, _leaves(ckpt.restore_state(ck_dir, self.EPOCHS))

    # (site, arm kwargs, durable step after the kill, samples skipped on
    # the resume replay): the JAX table's rows
    ROWS = [
        ("trainer.step", {"after": STEPS_PER_EPOCH}, 1, N),
        ("trainer.checkpoint", {}, None, 0),
        ("trainer.checkpoint.commit", {}, None, 0),
    ]

    @pytest.mark.parametrize("site,arm,durable,skipped", ROWS, ids=[r[0] for r in ROWS])
    def test_kill_then_resume_bit_identical(self, tmp_path, control, site, arm, durable,
                                            skipped):
        frames, control_leaves = control
        ck_dir = str(tmp_path / "ck")
        FAULTS.arm(site, exc=RuntimeError(f"injected kill at {site}"), times=1, **arm)
        killed = self._run(ck_dir, frames)
        FAULTS.reset()
        assert killed.error is not None
        assert ckpt.latest_step(ck_dir) == durable
        if site == "trainer.checkpoint.commit":
            # the torn-save gap: the state file exists, the marker doesn't:
            # invisible to latest_step, overwritten by the resume run
            assert os.path.isfile(os.path.join(ck_dir, "step_1", "state.pt"))
        resumed = self._run(ck_dir, frames, resume=True)
        assert resumed.error is None
        assert resumed.status.epoch_count == self.EPOCHS
        assert resumed.resumes == (1 if durable is not None else 0)
        assert resumed.replay_skipped == skipped
        assert resumed.gap_samples == 0
        # the (epoch, sample_index) ledger holds no duplicates and, with
        # the skipped replay, every sample of every epoch exactly once
        assert len(resumed.trained_log) == len(set(resumed.trained_log))
        assert len(resumed.trained_log) + skipped == self.EPOCHS * N
        assert ckpt.latest_step(ck_dir) == self.EPOCHS
        leaves = _leaves(ckpt.restore_state(ck_dir, self.EPOCHS))
        assert len(leaves) == len(control_leaves)
        for a, b in zip(leaves, control_leaves):
            assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# Supervision
# ---------------------------------------------------------------------------
class TestTrainerSupervision:
    def _push_epoch(self, src, frames, ep, n=N, sleep=0.0):
        for i in range(n):
            fr = TensorFrame([frames[i][0], frames[i][1]])
            fr.meta["epoch"] = ep
            fr.meta["sample_index"] = i
            src.push(fr)
            if sleep:
                time.sleep(sleep)

    def test_quiet_stream_death_surfaces(self, tmp_path):
        """A trainer that dies with no further frames arriving must not
        hang until EOS: the sweep routes the error through fail-stop
        within seconds and wait() raises."""
        cfg_path = tmp_path / "cfg.json"
        cfg_path.write_text(json.dumps(CFG))
        pipe = parse_pipeline(
            f"appsrc name=src ! {TRAINER} model-config={cfg_path} epochs=3 ! "
            "tensor_sink name=out")
        pipe.start()
        frames = _make_frames()
        FAULTS.arm("trainer.step", exc=RuntimeError("chaos: quiet death"), times=1)
        self._push_epoch(pipe["src"], frames, 0)
        t0 = time.monotonic()
        with pytest.raises(ElementError, match="trainer failed"):
            pipe.wait(timeout=60)
        assert time.monotonic() - t0 < 30
        assert pipe.health()["train"]["state"] == "failed"
        assert pipe.health()["train"]["train_alive"] == 0
        pipe.stop()

    def test_restart_policy_revives_and_realigns(self, tmp_path):
        """error-policy=restart: the revived backend resumes from the
        durable checkpoint, drops the un-resumable partial epoch from the
        live stream (counted as gap), and completes the run."""
        cfg_path = tmp_path / "cfg.json"
        cfg_path.write_text(json.dumps(CFG))
        ck_dir = str(tmp_path / "ck")
        pipe = parse_pipeline(
            f"appsrc name=src ! {TRAINER} model-config={cfg_path} epochs=3 "
            f"checkpoint-path={ck_dir} checkpoint-interval=1 error-policy=restart "
            "max-restarts=3 ! tensor_sink name=out")
        pipe.start()
        frames = _make_frames()
        train = pipe["train"]
        self._push_epoch(pipe["src"], frames, 0)
        deadline = time.monotonic() + 120
        while ckpt.latest_step(ck_dir) != 1:
            assert time.monotonic() < deadline, "epoch-1 checkpoint missing"
            time.sleep(0.05)
        FAULTS.arm("trainer.step", exc=TransientError("chaos: preempted"), times=1)
        self._push_epoch(pipe["src"], frames, 1, sleep=0.01)
        deadline = time.monotonic() + 60
        while train.health_info()["train_restarts"] < 1:
            assert time.monotonic() < deadline, "supervisor never revived"
            time.sleep(0.05)
        FAULTS.reset()
        for ep in (2, 3, 4):
            self._push_epoch(pipe["src"], frames, ep)
        pipe["src"].end_of_stream()
        pipe.wait(timeout=300)
        h = train.health_info()
        assert h["train_restarts"] == 1
        assert h["train_resumes"] == 1
        assert h["train_epochs"] == 3
        assert h["train_gap_samples"] >= 1  # realign is counted, never silent
        assert not pipe.errors
        pipe.stop()


# ---------------------------------------------------------------------------
# Starvation-free co-hosting: the memory watermark pauses training
# ---------------------------------------------------------------------------
class TestPressurePause:
    def test_watermark_pauses_and_resumes(self, tmp_path):
        frames = _make_frames()
        data_path, json_path = _write_repo(str(tmp_path), frames)
        cfg_path = tmp_path / "cfg.json"
        cfg_path.write_text(json.dumps(CFG))
        pressure = {"on": True}
        pipe = parse_pipeline(
            f"datareposrc location={data_path} json={json_path} epochs=2 ! "
            f"{TRAINER} model-config={cfg_path} epochs=2 "
            f"checkpoint-path={tmp_path / 'ck'} ! tensor_sink name=out")
        pipe.enable_memory_monitor(
            high=0.90, low=0.75, sustain_s=0.0, min_poll_s=0.05,
            sample=lambda: ((95, 100, 0) if pressure["on"] else (10, 100, 0)),
        )
        pipe.start()
        train = pipe["train"]
        deadline = time.monotonic() + 60
        while not train.health_info()["train_paused"]:
            assert time.monotonic() < deadline, "pressure never paused training"
            time.sleep(0.02)
        h = train.health_info()
        assert h["train_pauses"] == 1
        frozen = h["train_steps"]
        time.sleep(0.3)  # paused means FROZEN, not slow
        assert train.health_info()["train_steps"] == frozen
        pressure["on"] = False
        pipe.wait(timeout=300)
        h = train.health_info()
        assert h["train_paused"] == 0
        assert h["train_epochs"] == 2
        assert h["train_samples"] == 2 * N  # resumable pause: zero loss
        assert h["train_pauses"] == 1
        pipe.stop()

    def test_manual_pause_holds_no_frame(self, tmp_path):
        """``pause=true`` at runtime freezes the steps; the trainer takes
        no frame from its queue while paused, and unpausing finishes the
        run with every sample trained."""
        frames = _make_frames()
        data_path, json_path = _write_repo(str(tmp_path), frames)
        cfg_path = tmp_path / "cfg.json"
        cfg_path.write_text(json.dumps(CFG))
        pipe = parse_pipeline(
            f"datareposrc location={data_path} json={json_path} epochs=2 ! "
            f"{TRAINER} model-config={cfg_path} epochs=2 pause=true ! tensor_sink name=out")
        pipe.start()
        train = pipe["train"]
        deadline = time.monotonic() + 60
        while train.backend is None or not train.backend.thread_alive():
            assert time.monotonic() < deadline, "training never started"
            time.sleep(0.02)
        time.sleep(0.3)
        h = train.health_info()
        assert h["train_paused"] == 1 and h["train_steps"] == 0 and h["train_samples"] == 0
        train.set_property("pause", False)
        pipe.wait(timeout=300)
        h = train.health_info()
        assert h["train_paused"] == 0 and h["train_samples"] == 2 * N
        assert h["train_pauses"] == 0  # set before the backend existed: not counted, as in JAX
        pipe.stop()


# ---------------------------------------------------------------------------
# Truncated-repo prefix -> trainer
# ---------------------------------------------------------------------------
class TestTruncatedRepoTraining:
    def test_trains_on_complete_prefix(self, tmp_path):
        frames = _make_frames(n=24)
        # claim 24 samples, end the file mid-sample-17
        data_path, json_path = _write_repo(
            str(tmp_path), frames, claim=24, truncate_bytes=7 * (28 * 28 * 4 + 4) + 100)
        cfg_path = tmp_path / "cfg.json"
        cfg_path.write_text(json.dumps(CFG))
        health = {}
        for name, parse, trainer in (
                ("torch", parse_pipeline, TRAINER),
                ("jax", jax_parse, TRAINER.replace("accelerator=cpu", "framework=jax"))):
            pipe = parse(
                f"datareposrc name=repo location={data_path} json={json_path} epochs=1 ! "
                f"{trainer} model-config={cfg_path} epochs=1 ! tensor_sink name=out")
            pipe.start()
            pipe.wait(timeout=300)
            assert not pipe.errors
            health[name] = (pipe.health()["repo"]["truncated_samples"],
                            {k: v for k, v in pipe["train"].health_info().items()
                             if k not in ("train_loss", "train_alive")})  # alive: racy at EOS
            pipe.stop()
        assert health["torch"] == health["jax"]
        truncated, h = health["torch"]
        assert truncated == 8
        assert h["train_epochs"] == 1
        assert h["train_samples"] == N  # the complete 16-sample prefix
