"""PyTorch trainer delegate (``framework=torch``), the in-framework analog
of NNTrainer.

Port of ``nnstreamer_tpu/trainer/jax_trainer.py`` (less its ``mesh``,
ROADMAP A11, and its MNIST epoch benchmark, A9.2).  Model config (the
``model-config`` property, JSON file or inline JSON), the JAX trainer's::

    {"arch": "mnist_cnn", "arch_props": {"dtype": "float32"},
     "optimizer": "adam", "learning_rate": 1e-3, "batch_size": 32,
     "loss": "softmax_ce"}

Data protocol (≙ trainer ABI push_data, SURVEY §3.4): each incoming frame
carries ``num-inputs`` input tensors followed by ``num-labels`` label
tensors; every ``num-training-samples`` + ``num-validation-samples`` frames
form one epoch (train split first, then validation).

The training loop runs on a dedicated thread, on a CUDA stream of its own
where the model lives on a card, so its steps never wait for the
pipeline's streaming threads nor make them wait; samples stream in
through a bounded queue (backpressure to the pipeline).  The model stays
in eval mode (no dropout, batch norm on its running statistics), as the
JAX zoo's ``apply`` runs it, and gradients flow through it.  The trainer
changes no process-wide setting: TF32 and deterministic algorithms are
the caller's.

Optimizers are ``torch.optim`` with optax's defaults spelled out:
``adam`` and ``adamw`` take b1 0.9, b2 0.999, eps 1e-8 (optax's
``eps_root`` 0 is Adam's form), ``adamw`` weight decay 1e-4 (optax's; torch
defaults to 1e-2), and ``sgd`` no momentum.  The optimizer updates float32
masters (:class:`FloatMasters`): the JAX zoo keeps flax's default float32
``param_dtype`` and casts each parameter to the compute dtype at use, so
optax updates float32 weights with float32 moments.  A bf16 module's own
parameters are the masters' copies in bf16, written after every step.

Frames that carry card tensors are ordered after the stream that was
current when they reached ``push_data`` (an event the training stream
waits on) and recorded on the training stream, so the producer's
allocator cannot reuse them while a step still reads them.  A producer on
a stream of its own hands frames over once that stream is ordered after
its thread's current stream.

Crash safety, as the JAX trainer has it: step-grain durable checkpoints
(``checkpoint-steps=N``, plus every epoch boundary) under
``checkpoint-path``, each committed by an atomic completion marker
(``core/checkpoint.py``) carrying the data cursor; exact-step resume
(``resume=true``) that skips the datarepo replay by the cursor's stream
position; a resumable pause between steps; and the fault sites
``trainer.step``, ``trainer.checkpoint`` and ``trainer.checkpoint.commit``
on ``core/resilience.py`` ``FAULTS``.

Model files: ``model-save-path`` is written as a ``torch.save``d
``state_dict`` through ``atomic_write_bytes``, and ``model-load-path``
read back the same way.  A ``.msgpack`` path (the JAX package's flax
format) is refused when the trainer starts.  Placement: ``accelerator``
(the filter's grammar) picks the card, ``cuda:0`` by default, or the CPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.buffer import TensorFrame
from ..core.log import get_logger
from .base import (
    EVENT_EPOCH_COMPLETION,
    EVENT_TRAINING_COMPLETION,
    TrainerBackend,
    TrainerStatus,
    register_trainer,
)

log = get_logger("torch-trainer")

#: optax's defaults for each optimizer name, as ``torch.optim`` arguments
OPTIMIZERS = {
    "adam": (torch.optim.Adam, {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0.0}),
    "adamw": (torch.optim.AdamW, {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}),
    "sgd": (torch.optim.SGD, {"momentum": 0.0}),
}


def _truthy(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def check_props(props: Dict[str, Any]) -> torch.device:
    """Refuse what the trainer cannot run, before any frame flows: a
    ``.msgpack`` model path, a ``mesh``; returns the device that
    ``accelerator`` picks (raises when none is)."""
    from ..backends.base import parse_accelerator
    from ..backends.torch_cuda import pick_device

    for key in ("model-save-path", "model-load-path"):
        path = str(props.get(key) or "")
        if path.endswith(".msgpack"):
            raise ValueError(
                f"{key}={path}: a .msgpack file is the JAX package's flax format; the torch "
                "trainer reads and writes a torch.save'd state_dict (name it .pt)")
    if str(props.get("mesh") or "").strip() not in ("", "0", "off", "none"):
        raise NotImplementedError(
            "tensor_trainer mesh= (sharded train steps) is not ported (ROADMAP A11)")
    enabled, wishes = parse_accelerator(str(props.get("accelerator") or ""))
    return pick_device(wishes if enabled else ["cpu"])


def _first(out):
    return out[0] if isinstance(out, (list, tuple)) else out


def make_loss_fn(module: torch.nn.Module, loss_kind: str):
    """The loss the trainer's train and eval steps share (JAX
    ``make_loss_fn``): ``loss_fn(xs, ys) -> (loss, accuracy)``.
    ``softmax_ce`` takes integer labels of any shape, or one-hot labels
    only when their trailing dim is the class dim; ``mse`` casts the
    target to the logits' dtype and reports accuracy 0."""
    if loss_kind not in ("softmax_ce", "mse"):
        raise ValueError(f"unknown loss {loss_kind!r}")

    def loss_fn(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor]):
        logits = _first(module(*xs))
        if loss_kind == "mse":
            target = ys[0].to(logits.dtype)
            return torch.mean((logits - target) ** 2), logits.new_zeros(())
        labels = ys[0]
        # one-hot only when the trailing dim is the class dim; (B, 1)
        # integer labels must NOT be argmax'd
        if labels.dim() == logits.dim() and labels.shape[-1] == logits.shape[-1]:
            labels = labels.argmax(-1)
        labels = labels.reshape(-1).long()
        ll = F.log_softmax(logits, dim=-1).gather(-1, labels[:, None])[:, 0]
        acc = (logits.argmax(-1) == labels).float().mean()
        return -ll.mean(), acc

    return loss_fn


def _ready_event(frame: TensorFrame) -> Optional["torch.cuda.Event"]:
    """An event on the current stream of the first card tensor's device,
    recorded where the frame arrives, or None for a frame of host data."""
    for t in frame.tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(t.device))
            return event
    return None


def _take_over(frame: TensorFrame, ready: Optional["torch.cuda.Event"]) -> None:
    """Order this thread's current stream after the frame's producer and
    keep the frame's card tensors alive for it (``record_stream``)."""
    if ready is None:
        return
    for t in frame.tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            stream = torch.cuda.current_stream(t.device)
            stream.wait_event(ready)
            t.record_stream(stream)


class FloatMasters:
    """float32 master copies of a module's parameters in a lower precision.

    ``params`` is what the optimizer updates: the float32 parameters
    themselves and a master for each other one, taken from ``source`` (a
    loaded ``state_dict``, which may hold float32 values finer than the
    module's) or else from the parameter.  After a backward pass
    :meth:`grads_up` moves each low-precision gradient onto its master;
    after the optimizer step :meth:`copy_down` rounds the masters into the
    module."""

    def __init__(self, module: torch.nn.Module, source: Optional[Dict[str, Any]] = None):
        self.module = module
        self.params: Dict[str, torch.nn.Parameter] = {}
        self._pairs: List[Tuple[torch.nn.Parameter, torch.nn.Parameter]] = []
        for name, p in module.named_parameters():
            if p.dtype == torch.float32:
                self.params[name] = p
                continue
            src = source[name] if source is not None else p.detach()
            master = torch.nn.Parameter(src.detach().to(p.device, torch.float32, copy=True))
            self.params[name] = master
            self._pairs.append((p, master))

    def grads_up(self) -> None:
        for p, master in self._pairs:
            master.grad = None if p.grad is None else p.grad.float()
            p.grad = None

    def copy_down(self) -> None:
        with torch.no_grad():
            for p, master in self._pairs:
                p.copy_(master)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The module's ``state_dict`` with the float32 masters in place of
        the parameters they hold."""
        sd = self.module.state_dict()
        sd.update({k: v.detach() for k, v in self.params.items()})
        return sd

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        self.module.load_state_dict(sd, strict=True)
        with torch.no_grad():
            for name, master in self.params.items():
                master.copy_(sd[name])


def make_steps(masters: FloatMasters, cfg: Dict[str, Any]):
    """``(optimizer, train_step, eval_step)`` for a model config: the
    optimizer over ``masters.params``; ``train_step(xs, ys)`` takes one
    optimizer step and returns the loss and accuracy as card tensors,
    ``eval_step`` the same without a gradient."""
    cls, defaults = OPTIMIZERS[cfg.get("optimizer", "adam")]
    opt = cls(masters.params.values(), lr=float(cfg.get("learning_rate", 1e-3)), **defaults)
    loss_fn = make_loss_fn(masters.module, cfg.get("loss", "softmax_ce"))

    def train_step(xs, ys):
        opt.zero_grad(set_to_none=True)
        loss, acc = loss_fn(xs, ys)
        loss.backward()
        masters.grads_up()
        opt.step()
        masters.copy_down()
        return loss.detach(), acc.detach()

    def eval_step(xs, ys):
        with torch.no_grad():
            return loss_fn(xs, ys)

    return opt, train_step, eval_step


def _stack(items: List[Any], device: torch.device) -> torch.Tensor:
    """One batch tensor on `device` from a list of per-sample tensors."""
    if all(isinstance(a, np.ndarray) for a in items):
        return torch.from_numpy(np.stack(items)).to(device)
    return torch.stack([torch.as_tensor(a).to(device) for a in items])


def _floats(xs: List[Any]) -> List[float]:
    return [float(x) for x in xs]


def save_model(path: str, state: Dict[str, torch.Tensor]) -> None:
    """A ``state_dict`` as a ``torch.save``d file, written crash-atomically
    (a co-hosted serving filter never loads a torn file)."""
    from ..core.checkpoint import atomic_write_bytes, to_bytes

    atomic_write_bytes(path, to_bytes({k: v.detach().cpu() for k, v in state.items()}))


class TorchTrainer(TrainerBackend):
    NAME = "torch"

    def __init__(self):
        super().__init__()
        self._cfg: Dict[str, Any] = {}
        self._props: Dict[str, Any] = {}
        self._q: "queue.Queue[Optional[TensorFrame]]" = queue.Queue(256)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._held = threading.Event()  # set while no train step is under way
        self._held.set()
        self.module: Optional[torch.nn.Module] = None
        self.masters: Optional[FloatMasters] = None
        self.device = torch.device("cpu")
        self.error: Optional[BaseException] = None
        self._last_ckpt_id: Optional[int] = None
        # exact step/sample accounting (the element exports these as
        # nns.train.*; the kill/resume truth table pins them)
        self.steps = 0                # optimizer steps completed
        self.samples_trained = 0      # samples incorporated by train steps
        self.checkpoints = 0          # durable (marker-committed) saves
        self.resumes = 0              # restores from a durable checkpoint
        self.resumed_at = -1          # global step the last resume restored
        self.replay_skipped = 0       # already-trained frames skipped on resume
        self.gap_samples = 0          # frames dropped realigning a mid-stream restart
        self.trained_log: List[Tuple[int, int]] = []  # (epoch, sample_index) ledger
        # on a card, an event on the training stream at each step's end:
        # consecutive ones time the trainer's steps, host work included
        self.step_ends: "deque[torch.cuda.Event]" = deque(maxlen=1024)

    check_props = staticmethod(check_props)

    # -- ABI ----------------------------------------------------------------
    def create(self, props: Dict[str, Any]) -> None:
        self._props = dict(props)
        self.device = check_props(self._props)
        cfg_text = props.get("model-config") or "{}"
        if os.path.isfile(cfg_text):
            with open(cfg_text) as f:
                self._cfg = json.load(f)
        else:
            self._cfg = json.loads(cfg_text)
        if "arch" not in self._cfg:
            raise ValueError("trainer model-config must name an 'arch'")
        if self._cfg.get("optimizer", "adam") not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self._cfg['optimizer']!r}; "
                             f"available: {sorted(OPTIMIZERS)}")

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._train_loop, name="torch-trainer", daemon=True
        )
        self._thread.start()

    def push_data(self, frame: TensorFrame) -> None:
        item = (frame, _ready_event(frame))
        while not self._stop.is_set():
            if self._thread is not None and not self._thread.is_alive():
                return  # trainer died; don't spin (its error is surfaced)
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _put_sentinel(self) -> None:
        # never block: if the queue is full the consumer is gone — drain one
        try:
            self._q.put_nowait(None)
        except queue.Full:
            try:
                self._q.get_nowait()
                self._q.put_nowait(None)
            except (queue.Empty, queue.Full):
                pass

    def end_of_data(self) -> None:
        # block-put like push_data: the consumer is still alive here, and a
        # lossy put would drop a real sample from the final epoch
        while not self._stop.is_set():
            if self._thread is None or not self._thread.is_alive():
                self._put_sentinel()
                return
            try:
                self._q.put(None, timeout=0.2)
                return
            except queue.Full:
                continue

    def stop(self) -> None:
        self._stop.set()
        self._put_sentinel()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def thread_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- resumable pause (starvation-free co-hosting) ------------------------
    def pause(self) -> None:
        """Stop taking train steps at the next step boundary.  The loop
        stops consuming, the bounded queue backpressures the pipeline:
        resumable, zero samples lost."""
        self._paused.set()

    def unpause(self) -> None:
        self._paused.clear()

    @property
    def paused(self) -> bool:
        """True once a requested pause holds: no step is under way."""
        return self._paused.is_set() and self._held.is_set()

    # -- internals ----------------------------------------------------------
    def _build(self):
        from .. import models as zoo

        arch_props = {k: str(v) for k, v in self._cfg.get("arch_props", {}).items()}
        module, _, _ = zoo.build(self._cfg["arch"], arch_props)
        load_path = self._props.get("model-load-path")
        loaded = (torch.load(load_path, map_location="cpu", weights_only=True)
                  if load_path else None)
        if loaded is not None:
            module.load_state_dict(loaded, strict=True)
        module = module.to(self.device).eval()
        self.masters = FloatMasters(module, loaded)
        return (module, *make_steps(self.masters, self._cfg))

    def _mark_step(self) -> None:
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.step_ends.append(event)

    def _batch(self, samples, device) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        xs = [_stack([s[0][t] for s in samples], device) for t in range(len(samples[0][0]))]
        ys = [_stack([s[1][t] for s in samples], device) for t in range(len(samples[0][1]))]
        return xs, ys

    def _batches(self, samples, batch_size: int):
        for i in range(0, len(samples), batch_size):
            yield self._batch(samples[i : i + batch_size], self.device)

    def _train_loop(self) -> None:
        stream = None
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            try:
                self.module, opt, train_step, eval_step = self._build()
                cursor = self._maybe_resume(opt)
            except Exception as e:
                log.exception("trainer build failed")
                self.error = e  # surfaced by the element's watchdog sweep
                self.notify(EVENT_TRAINING_COMPLETION)
                return
            try:
                self._train_body(opt, train_step, eval_step, cursor)
                if stream is not None:
                    stream.synchronize()
            except Exception as e:
                log.exception("training failed")
                self.error = e
        self._held.set()
        self.notify(EVENT_TRAINING_COMPLETION)

    def _maybe_resume(self, opt) -> Optional[Dict[str, Any]]:
        """Durable-checkpoint resume: restore the weights, the optimizer
        state and the data cursor from the newest marker-committed
        checkpoint under ``checkpoint-path`` when ``resume=1``.  Torn
        saves are invisible (core/checkpoint.py)."""
        from ..core import checkpoint as ckpt

        path = self._props.get("checkpoint-path")
        if not (path and _truthy(self._props.get("resume", False))):
            return None
        step = ckpt.latest_step(path)
        if step is None:
            log.info("resume requested but no checkpoint under %s", path)
            return None
        state = ckpt.restore_state(path, step, map_location=self.device)
        self.masters.load_state_dict(state["params"])
        opt.load_state_dict(state["opt_state"])
        cursor = ckpt.load_meta(path, step).get("cursor")
        if cursor is None:
            # pre-cursor checkpoint id semantics: id == completed epochs
            cursor = {"unit": "epoch", "epoch": int(step), "epoch_pos": 0,
                      "stream_pos": 0, "step": 0}
        self.resumes += 1
        self.resumed_at = int(cursor.get("step", 0))
        self.steps = self.resumed_at
        log.info("resumed from %s step %d (cursor %s)", path, step, cursor)
        return cursor

    def _ckpt(self, opt, cursor: Dict[str, Any]) -> None:
        """One durable checkpoint: the state file, then the atomic
        completion marker carrying the data cursor.  The two fault sites
        bracket the torn-save gap."""
        from ..core import checkpoint as ckpt
        from ..core.resilience import FAULTS

        path = self._props.get("checkpoint-path")
        if not path:
            return
        cid = int(cursor["step"] if cursor["unit"] == "step" else cursor["epoch"])
        if cid == self._last_ckpt_id:
            return  # epoch boundary coinciding with a step checkpoint
        FAULTS.check("trainer.checkpoint")
        ckpt.write_state(path, cid, {"params": self.masters.state_dict(),
                                     "opt_state": opt.state_dict()})
        FAULTS.check("trainer.checkpoint.commit")
        ckpt.commit_state(path, cid, {"cursor": cursor})
        ckpt.prune(path, int(self._props.get("checkpoint-keep", 3)))
        self.checkpoints += 1
        self._last_ckpt_id = cid
        log.info("checkpointed %s %d to %s", cursor["unit"], cid, path)

    def _train_body(self, opt, train_step, eval_step,
                    cursor: Optional[Dict[str, Any]] = None) -> None:
        from ..core.resilience import FAULTS

        n_in = int(self._props.get("num-inputs", 1))
        n_lab = int(self._props.get("num-labels", 1))
        n_train = int(self._props.get("num-training-samples", 0))
        n_valid = int(self._props.get("num-validation-samples", 0))
        epochs = int(self._props.get("epochs", 1))
        batch_size = int(self._cfg.get("batch_size", 32))
        ckpt_steps = int(self._props.get("checkpoint-steps", 0) or 0)
        ckpt_interval = int(self._props.get("checkpoint-interval", 1))
        per_epoch = n_train + n_valid
        midstream = _truthy(self._props.get("_midstream-restart", False))

        cursor = cursor or {}
        done_epochs = int(cursor.get("epoch", 0))
        gstep = int(cursor.get("step", 0))
        epoch_pos = int(cursor.get("epoch_pos", 0))
        stream_pos = int(cursor.get("stream_pos", 0))
        # per-step losses stay on the device until an epoch ends or a
        # checkpoint records them: no host sync per step
        ep_losses: List[Any] = [float(x) for x in cursor.get("ep_losses", [])]
        ep_accs: List[Any] = [float(x) for x in cursor.get("ep_accs", [])]
        # resume fast-forward: the deterministic datarepo replay re-emits
        # every frame from sample 0; skip exactly the cursor's stream
        # position (only meta-stamped frames: a direct-API feed is the
        # caller resuming where IT left off, so nothing is skipped)
        skip_left = 0 if midstream else stream_pos
        # mid-stream backend restart: the live stream does NOT replay, and
        # frames between the checkpoint and the crash are gone: drop the
        # rest of the partial epoch (counted) and realign exactly at the
        # next epoch boundary the datarepo meta announces
        realign = midstream and per_epoch > 0
        realign_seen: Optional[int] = None

        train_buf: List[Tuple[List[Any], List[Any], Any]] = []
        valid_buf: List[Tuple[List[Any], List[Any], Any]] = []
        tail_buf: List[Tuple[List[Any], List[Any]]] = []

        def cursor_now(unit: str) -> Dict[str, Any]:
            c: Dict[str, Any] = {
                "unit": unit, "step": gstep, "epoch": done_epochs,
                "epoch_pos": epoch_pos, "stream_pos": stream_pos,
                "ep_losses": _floats(ep_losses), "ep_accs": _floats(ep_accs),
            }
            if self.trained_log:
                c["meta_epoch"], c["sample_index"] = self.trained_log[-1]
            return c

        def epoch_checkpoint() -> None:
            if ckpt_steps > 0:
                self._ckpt(opt, cursor_now("step"))
            elif ckpt_interval > 0 and done_epochs % ckpt_interval == 0:
                self._ckpt(opt, cursor_now("epoch"))

        def do_step(batch) -> None:
            nonlocal gstep, stream_pos
            FAULTS.check("trainer.step")
            xs, ys = self._batch(batch, self.device)
            loss, acc = train_step(xs, ys)
            self._mark_step()
            gstep += 1
            stream_pos += len(batch)
            self.steps = gstep
            self.samples_trained += len(batch)
            for s in batch:
                if s[2] is not None:
                    self.trained_log.append(s[2])
            ep_losses.append(loss)
            ep_accs.append(acc)
            if ckpt_steps > 0 and gstep % ckpt_steps == 0:
                self._ckpt(opt, cursor_now("step"))

        def finish_epoch() -> None:
            nonlocal done_epochs, epoch_pos, stream_pos
            nonlocal ep_losses, ep_accs, valid_buf
            vlosses, vaccs = [], []
            if valid_buf:
                for bx, by in self._batches([(s[0], s[1]) for s in valid_buf], batch_size):
                    loss, acc = eval_step(bx, by)
                    vlosses.append(float(loss))
                    vaccs.append(float(acc))
            for s in valid_buf:
                if s[2] is not None:
                    self.trained_log.append(s[2])
            stream_pos += len(valid_buf)
            done_epochs += 1
            epoch_pos = 0
            valid_buf = []
            losses, accs = _floats(ep_losses), _floats(ep_accs)
            self.status = TrainerStatus(
                epoch_count=done_epochs,
                training_loss=float(np.mean(losses)) if losses else 0.0,
                training_accuracy=float(np.mean(accs)) if accs else 0.0,
                validation_loss=float(np.mean(vlosses)) if vlosses else 0.0,
                validation_accuracy=float(np.mean(vaccs)) if vaccs else 0.0,
            )
            ep_losses, ep_accs = [], []
            self.notify(EVENT_EPOCH_COMPLETION)
            epoch_checkpoint()

        while not self._stop.is_set() and (epochs <= 0 or done_epochs < epochs):
            # resumable pause: between steps only, never mid-step, never
            # consuming (the bounded queue backpressures the pipeline)
            if self._paused.is_set():
                self._held.set()
                self._stop.wait(0.05)
                continue
            self._held.clear()
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None:
                break
            frame, ready = item
            _take_over(frame, ready)
            meta_ep = frame.meta.get("epoch") if frame.meta else None
            if skip_left > 0 and meta_ep is not None:
                skip_left -= 1
                self.replay_skipped += 1
                continue
            if realign and meta_ep is not None:
                if realign_seen is None:
                    realign_seen = int(meta_ep)
                if int(meta_ep) == realign_seen:
                    self.gap_samples += 1
                    continue
                realign = False  # fresh epoch boundary: exact from here
                epoch_pos = 0
                train_buf, valid_buf = [], []
                ep_losses, ep_accs = [], []
            elif realign and meta_ep is None:
                realign = False  # no meta: continue from the cursor as-is
            xs = list(frame.tensors[:n_in])
            ys = list(frame.tensors[n_in : n_in + n_lab])
            tag = (
                (int(meta_ep), int(frame.meta.get("sample_index", -1)))
                if meta_ep is not None else None
            )
            if not per_epoch:
                tail_buf.append((xs, ys))
                continue
            if epoch_pos < n_train:
                train_buf.append((xs, ys, tag))
                flush = len(train_buf) >= batch_size or epoch_pos == n_train - 1
            else:
                valid_buf.append((xs, ys, tag))
                flush = False
            epoch_pos += 1
            if flush:
                batch, train_buf = train_buf, []
                do_step(batch)
            if epoch_pos >= per_epoch:
                finish_epoch()

        if (train_buf or valid_buf) and not self._stop.is_set():
            log.warning(
                "dropping %d leftover samples (incomplete epoch of %d)",
                len(train_buf) + len(valid_buf), per_epoch,
            )
        if tail_buf and not self._stop.is_set():
            # num-training-samples unset: the whole stream is the dataset;
            # honor epochs= by re-iterating it instead of silently saving
            # the untrained init (done_epochs already counts resumed ones)
            while done_epochs < max(1, epochs) and not self._stop.is_set():
                for bx, by in self._batches(tail_buf, batch_size):
                    FAULTS.check("trainer.step")
                    loss, acc = train_step(bx, by)
                    self._mark_step()
                    gstep += 1
                    self.steps = gstep
                    self.samples_trained += len(bx[0])
                    ep_losses.append(loss)
                    ep_accs.append(acc)
                done_epochs += 1
                losses, accs = _floats(ep_losses), _floats(ep_accs)
                self.status = TrainerStatus(
                    epoch_count=done_epochs,
                    training_loss=float(np.mean(losses)) if losses else 0.0,
                    training_accuracy=float(np.mean(accs)) if accs else 0.0,
                )
                ep_losses, ep_accs = [], []
                self.notify(EVENT_EPOCH_COMPLETION)
                epoch_pos = 0
                epoch_checkpoint()
        save_path = self._props.get("model-save-path")
        if save_path and self.masters is not None:
            save_model(save_path, self.masters.state_dict())
            log.info("model saved to %s", save_path)


register_trainer(TorchTrainer)
