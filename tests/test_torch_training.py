"""In-pipeline training in the port (``datareposrc ! tensor_trainer``)
against the JAX package, on the CPU at small sizes.

* the datarepo: a repo written by either package's ``datareposink`` is
  byte-equal to the other's and reads back through either package's
  ``datareposrc`` as the same frames; index ranges, epochs,
  ``tensors-sequence`` and the shuffle order (``is-shuffle``, seeded per
  epoch) equal the JAX element's (``tests/test_training.py:35-92``);
  image mode, the sink's refusals, a killed writer and truncated repos
  on both packages alike (``tests/test_media_ingest.py:310-410``,
  ``tests/test_wire_integrity.py:831-``);
* the MNIST CNN's logits against the JAX build's on converted weights
  (float32, within 1e-5 absolute: the same function summed in another
  order);
* the MNIST CNN (``classes: 4``, 16 training + 4 validation samples,
  float32, batch 8, 3 epochs) trained by both trainers from the same
  repo and the same initial weights (``model-load-path``: the JAX init as
  msgpack, its ``state_dict_from_flax`` as ``.pt``): every optimizer
  step's loss, read from the step checkpoints' cursors, within rtol 1e-4
  for each of adam, adamw and sgd (Adam's normalised updates carry the
  frameworks' float32 rounding into later steps: 9.5e-5 was the largest
  seen, at a loss of 0.008; sgd agrees within 1.1e-7);
* a tiny ViT (2 layers, 32 wide, ``attn:flash``) trained by both trainers
  from the same weights: the flash forward and its recompute backward in
  the port against the JAX zoo's flash path, per-step losses within rtol
  1e-4;
* a bf16 model trains on float32 masters with float32 moments, as the
  JAX zoo's float32 ``param_dtype`` has optax do; the bf16 MNIST CNN
  trained by both trainers at lr 1e-4: per-step losses within rtol 2e-3
  and each parameter's change within 5e-2 of the JAX change's L2 norm;
* the pipeline contract of ``tests/test_training.py:95-172``: one stats
  frame per epoch, the loss falling, the saved model classifying at least
  9 of 12, the bus events, a warm start; a ``.msgpack`` path refused at
  ``start()``; frames of torch tensors training as their numpy twins do;
* a trainer's checkpoint directory and model file served by
  ``torch-cuda``: logits within 1e-6 of the trained weights' (the same
  float32 arithmetic, another batch size), a torn-only or JAX orbax
  directory refused.

Each trainer runs with ``accelerator=cpu``; torch runs on 2 threads.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from nnstreamer_tpu.models import build as jax_build
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.core import checkpoint as ckpt
from nnstreamer_tpu_torch.models import build as torch_build
from nnstreamer_tpu_torch.models import mnist_cnn, vit
from nnstreamer_tpu_torch.pipeline import parse_pipeline as torch_parse
from nnstreamer_tpu_torch.pipeline.element import ElementError

torch.set_num_threads(2)

PARSE = {"jax": jax_parse, "torch": torch_parse}
FRAMEWORK = {"jax": "framework=jax", "torch": "framework=torch accelerator=cpu"}
MNIST4 = {"dtype": "float32", "classes": "4"}
MNIST4_BF16 = {"dtype": "bfloat16", "classes": "4"}


def quadrant_image(rng, label):
    """The JAX tests' learnable sample: class = brightest quadrant."""
    img = rng.normal(0.2, 0.05, (28, 28, 1)).astype(np.float32)
    qy, qx = divmod(label, 2)
    img[qy * 14:(qy + 1) * 14, qx * 14:(qx + 1) * 14] += 0.8
    return img


def write_dataset(d, pkg="torch", n=20, seed=0):
    """`n` samples through `pkg`'s ``appsrc ! datareposink`` (the writer of
    ``tests/test_training.py``)."""
    os.makedirs(d, exist_ok=True)
    data_path, json_path = os.path.join(d, "data.bin"), os.path.join(d, "data.json")
    rng = np.random.default_rng(seed)
    pipe = PARSE[pkg](f"appsrc name=src ! datareposink location={data_path} json={json_path}")
    pipe.start()
    for i in range(n):
        pipe["src"].push([quadrant_image(rng, i % 4), np.int64([i % 4])])
    pipe["src"].end_of_stream()
    pipe.wait(timeout=30)
    pipe.stop()
    return data_path, json_path


def read_frames(pkg, data, meta, extra=""):
    pipe = PARSE[pkg](f"datareposrc location={data} json={meta} {extra} ! tensor_sink name=out")
    pipe.run(timeout=30)
    return pipe["out"].frames


def assert_same_frames(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.meta["epoch"], g.meta["sample_index"]) == (w.meta["epoch"],
                                                            w.meta["sample_index"])
        assert len(g.tensors) == len(w.tensors)
        for a, b in zip(g.tensors, w.tensors):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# -- the datarepo ----------------------------------------------------------------------------

def test_sink_bytes_equal_jax(tmp_path):
    paths = {pkg: write_dataset(str(tmp_path / pkg), pkg, n=6) for pkg in PARSE}
    for a, b in zip(paths["torch"], paths["jax"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    meta = json.load(open(paths["torch"][1]))
    assert meta["total_samples"] == 6 and meta["tensors"][0].startswith("float32")


def test_sink_takes_torch_tensors(tmp_path):
    """Torch tensors in, the same bytes as the numpy arrays they hold."""
    rng = np.random.default_rng(3)
    samples = [(rng.random((4, 3), np.float32), np.int32([i])) for i in range(3)]
    paths = []
    for name, conv in (("np", lambda a: a), ("torch", torch.from_numpy)):
        d = tmp_path / name
        d.mkdir()
        paths.append((str(d / "data.bin"), str(d / "data.json")))
        pipe = torch_parse(f"appsrc name=src ! datareposink location={paths[-1][0]} "
                           f"json={paths[-1][1]}")
        pipe.start()
        for x, y in samples:
            pipe["src"].push([conv(x), conv(y)])
        pipe["src"].end_of_stream()
        pipe.wait(timeout=30)
        pipe.stop()
    for a, b in zip(*paths):
        assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_repo_reads_alike_in_both_packages(tmp_path, writer):
    data, meta = write_dataset(str(tmp_path), writer, n=6)
    got, want = read_frames("torch", data, meta), read_frames("jax", data, meta)
    assert_same_frames(got, want)
    assert len(got) == 6
    assert got[0].tensors[0].shape == (28, 28, 1) and got[0].tensors[1].shape == (1,)


def test_index_range_and_epochs(tmp_path):
    data, meta = write_dataset(str(tmp_path), n=10)
    extra = "start-sample-index=2 stop-sample-index=4 epochs=3"
    got = read_frames("torch", data, meta, extra)
    assert_same_frames(got, read_frames("jax", data, meta, extra))
    assert len(got) == 9  # 3 samples x 3 epochs
    assert [f.meta["sample_index"] for f in got[:3]] == [2, 3, 4]


def test_shuffle_order_equals_jax(tmp_path):
    data, meta = write_dataset(str(tmp_path), n=8)
    extra = "is-shuffle=true shuffle-seed=42 epochs=2"
    got = read_frames("torch", data, meta, extra)
    assert_same_frames(got, read_frames("jax", data, meta, extra))
    order = [f.meta["sample_index"] for f in got]
    assert order == [f.meta["sample_index"] for f in read_frames("torch", data, meta, extra)]
    assert order[:8] != sorted(order[:8]) and order[:8] != order[8:]  # shuffled, per epoch


def test_tensors_sequence_reorder(tmp_path):
    data, meta = write_dataset(str(tmp_path), n=2)
    got = read_frames("torch", data, meta, "tensors-sequence=1,0")
    assert_same_frames(got, read_frames("jax", data, meta, "tensors-sequence=1,0"))
    assert got[0].tensors[0].shape == (1,)  # label first now


def test_missing_meta_raises(tmp_path):
    pipe = torch_parse(f"datareposrc location={tmp_path}/none.bin "
                       f"json={tmp_path}/none.json ! tensor_sink name=out")
    with pytest.raises(FileNotFoundError):
        pipe.start()
    pipe.stop()


# -- the model and the optimizers -------------------------------------------------------------

def test_mnist_cnn_logits_equal_jax():
    fn, params, _, jout = jax_build("mnist_cnn", MNIST4)
    module, _, out_spec = torch_build("mnist_cnn", MNIST4)
    module.load_state_dict(mnist_cnn.state_dict_from_flax(params), strict=True)
    assert out_spec.tensors[0].shape == jout.tensors[0].shape
    rng = np.random.default_rng(1)
    for x in (rng.random((3, 28, 28, 1), np.float32),
              rng.integers(0, 256, (3, 28, 28, 1), dtype=np.uint8)):
        with torch.no_grad():
            got = module(torch.from_numpy(x)).numpy()
            single = module(torch.from_numpy(x[0])).numpy()
        want = np.asarray(fn(params, [x])[0])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(single, want[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_bf16_model_keeps_float32_masters_and_moments(optimizer):
    """The JAX zoo's bf16 MNIST CNN has float32 parameters (flax's
    ``param_dtype``), so optax keeps float32 moments; the port's optimizer
    updates float32 masters with float32 moments, and the module holds
    their bf16 copies."""
    from nnstreamer_tpu_torch.trainer.torch_trainer import FloatMasters, make_steps

    _, params, _, _ = jax_build("mnist_cnn", MNIST4_BF16)
    state = getattr(optax, optimizer)(1e-3).init(params)
    assert {a.dtype for a in jax.tree_util.tree_leaves((params, state[0].mu, state[0].nu))} \
        == {jnp.dtype(jnp.float32)}
    module, _, _ = torch_build("mnist_cnn", MNIST4_BF16)
    masters = FloatMasters(module, mnist_cnn.state_dict_from_flax(params))
    opt, train_step, _ = make_steps(masters, {"optimizer": optimizer, "learning_rate": 1e-3})
    x = torch.from_numpy(np.random.default_rng(5).random((2, 28, 28, 1), np.float32))
    train_step([x], [torch.tensor([[1], [3]])])
    assert {p.dtype for p in opt.state} == {torch.float32}
    assert {t.dtype for s in opt.state.values() for k, t in s.items() if k != "step"} \
        == {torch.float32}
    for name, p in module.named_parameters():
        want = masters.params[name].detach().to(p.dtype)
        assert torch.equal(p.detach(), want), name
        assert p.grad is None or p is masters.params[name]  # the float32 head is its own master
    assert module.conv1.weight.dtype == torch.bfloat16


@pytest.fixture(scope="module")
def mnist_repo(tmp_path_factory):
    """The 16+4 sample repo and the JAX init as both packages' files."""
    d = tmp_path_factory.mktemp("mnist")
    data, meta = write_dataset(str(d), n=20)
    _, params, _, _ = jax_build("mnist_cnn", MNIST4)
    (d / "init.msgpack").write_bytes(serialization.to_bytes(params))
    torch.save(mnist_cnn.state_dict_from_flax(params), d / "init.pt")
    return d, data, meta


def step_losses(pkg, d, data, meta, cfg, inits, epochs=3, n_train=16, n_valid=4, extra=""):
    """Train through `pkg`'s pipeline with a checkpoint at every step and
    read each step's loss back from the cursors (``ep_losses``)."""
    tag = f"{pkg}_{cfg['optimizer']}_{cfg['arch']}"
    ck_dir = str(d / f"ck_{tag}")
    shutil.rmtree(ck_dir, ignore_errors=True)
    (d / f"{tag}.json").write_text(json.dumps(cfg))
    pipe = PARSE[pkg](
        f"datareposrc location={data} json={meta} epochs={epochs} ! "
        f"tensor_trainer {FRAMEWORK[pkg]} model-config={d / f'{tag}.json'} "
        f"model-load-path={inits[pkg]} num-inputs=1 num-labels=1 "
        f"num-training-samples={n_train} num-validation-samples={n_valid} epochs={epochs} "
        f"checkpoint-path={ck_dir} checkpoint-steps=1 checkpoint-keep=0 {extra} ! "
        "tensor_sink name=out")
    pipe.run(timeout=300)
    steps = epochs * -(-n_train // cfg["batch_size"])
    assert ckpt.latest_step(ck_dir) == steps
    return np.array([ckpt.load_meta(ck_dir, s)["cursor"]["ep_losses"][-1]
                     for s in range(1, steps + 1)]), [f.tensors[0] for f in pipe["out"].frames]


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd"])
def test_losses_equal_jax(mnist_repo, optimizer):
    d, data, meta = mnist_repo
    cfg = {"arch": "mnist_cnn", "arch_props": MNIST4, "optimizer": optimizer,
           "learning_rate": 5e-3, "batch_size": 8}
    inits = {"jax": d / "init.msgpack", "torch": d / "init.pt"}
    got, got_stats = step_losses("torch", d, data, meta, cfg, inits)
    want, want_stats = step_losses("jax", d, data, meta, cfg, inits)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert len(got_stats) == len(want_stats) == 3
    for g, w in zip(got_stats, want_stats):
        assert g[0] == w[0]
        np.testing.assert_allclose(g[1:], w[1:], rtol=1e-4, atol=1e-6)


def test_bf16_training_follows_jax(mnist_repo):
    """The bf16 MNIST CNN trained by both trainers from the same float32
    init at lr 1e-4, where an Adam step is below half a bf16 ulp of most
    weights: per-step losses within rtol 2e-3 (bf16 compute in both: 8.7e-4
    seen), and each parameter's change over the run within 5e-2 of the JAX
    change's L2 norm (3.0e-2 seen).  A trainer that steps the bf16 weights
    themselves is off by 6.5e-3 in the losses and by 0.36 to 1.7 in the
    weights' changes."""
    d, data, meta = mnist_repo
    cfg = {"arch": "mnist_cnn", "arch_props": MNIST4_BF16, "optimizer": "adam",
           "learning_rate": 1e-4, "batch_size": 8}
    inits = {"jax": d / "init.msgpack", "torch": d / "init.pt"}
    saved = {"jax": d / "bf16.msgpack", "torch": d / "bf16.pt"}
    got, _ = step_losses("torch", d, data, meta, cfg, inits,
                         extra=f"model-save-path={saved['torch']}")
    want, _ = step_losses("jax", d, data, meta, cfg, inits,
                          extra=f"model-save-path={saved['jax']}")
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=0)
    init = torch.load(inits["torch"], weights_only=True)
    _, template, _, _ = jax_build("mnist_cnn", MNIST4)
    jax_final = mnist_cnn.state_dict_from_flax(
        serialization.from_bytes(template, saved["jax"].read_bytes()))
    port_final = torch.load(saved["torch"], weights_only=True)
    for name, start in init.items():
        assert port_final[name].dtype == torch.float32
        moved, want_moved = port_final[name] - start, jax_final[name] - start
        rel = float((moved - want_moved).norm() / want_moved.norm())
        assert rel <= 5e-2, (name, rel)


def test_vit_flash_losses_equal_jax(tmp_path):
    """The slice's attention path: ViT ``attn:flash`` trained in both
    packages, the port's flash forward and recompute backward against the
    JAX zoo's ``flash_attention_grad`` path."""
    props = {"size": "32", "patch": "16", "d_model": "32", "heads": "2", "layers": "2",
             "d_ff": "64", "classes": "4", "dtype": "float32", "attn": "flash"}
    rng = np.random.default_rng(2)
    data, meta = str(tmp_path / "data.bin"), str(tmp_path / "data.json")
    pipe = torch_parse(f"appsrc name=src ! datareposink location={data} json={meta}")
    pipe.start()
    for i in range(12):
        pipe["src"].push([rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                          np.int32([i % 4])])
    pipe["src"].end_of_stream()
    pipe.wait(timeout=30)
    pipe.stop()
    _, params, _, _ = jax_build("vit", props)
    params = jax.tree_util.tree_map(  # cls and pos_embed away from flax's zeros-ish init
        lambda a: a + np.float32(0.01) * np.random.default_rng(3).standard_normal(
            a.shape).astype(np.float32), params)
    (tmp_path / "init.msgpack").write_bytes(serialization.to_bytes(params))
    torch.save(vit.state_dict_from_flax(params), tmp_path / "init.pt")
    cfg = {"arch": "vit", "arch_props": props, "optimizer": "adam", "learning_rate": 1e-3,
           "batch_size": 4}
    inits = {"jax": tmp_path / "init.msgpack", "torch": tmp_path / "init.pt"}
    got, _ = step_losses("torch", tmp_path, data, meta, cfg, inits, epochs=2, n_train=12,
                         n_valid=0)
    want, _ = step_losses("jax", tmp_path, data, meta, cfg, inits, epochs=2, n_train=12,
                          n_valid=0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


# -- the pipeline contract -------------------------------------------------------------------

def test_mnist_cnn_trains(tmp_path):
    n_train, n_valid, epochs = 16, 4, 3
    data, meta = write_dataset(str(tmp_path), n=n_train + n_valid)
    cfg = {"arch": "mnist_cnn", "arch_props": MNIST4, "optimizer": "adam",
           "learning_rate": 5e-3, "batch_size": 8}
    cfg_path = str(tmp_path / "cfg.json")
    json.dump(cfg, open(cfg_path, "w"))
    save_path = str(tmp_path / "model.pt")
    pipe = torch_parse(
        f"datareposrc location={data} json={meta} epochs={epochs} ! "
        f"tensor_trainer name=t model-config={cfg_path} accelerator=cpu "
        f"model-save-path={save_path} num-inputs=1 num-labels=1 "
        f"num-training-samples={n_train} num-validation-samples={n_valid} "
        f"epochs={epochs} ! tensor_sink name=out")
    messages = []
    pipe.add_bus_watcher(messages.append)
    pipe.run(timeout=120)
    stats = pipe["out"].frames
    assert len(stats) == epochs  # one stats frame per epoch
    first, last = stats[0].tensors[0], stats[-1].tensors[0]
    assert last[0] == epochs and last[1] < first[1]
    # the saved model must actually classify: reload and predict
    module, _, _ = torch_build("mnist_cnn", MNIST4)
    module.load_state_dict(torch.load(save_path, weights_only=True), strict=True)
    rng = np.random.default_rng(0)  # the generator write_dataset used
    imgs = np.stack([quadrant_image(rng, i % 4) for i in range(12)])
    with torch.no_grad():
        pred = module(torch.from_numpy(imgs)).argmax(-1).numpy()
    correct = int((pred == np.arange(12) % 4).sum())
    assert correct >= 9, f"trained model only got {correct}/12"
    events = [k for m in messages if m.kind == "element" and m.source == "t" for k in m.data]
    assert "epoch-completion" in events and "training-completion" in events


def test_warm_start_load(tmp_path):
    data, meta = write_dataset(str(tmp_path), n=8)
    cfg_path = str(tmp_path / "cfg.json")
    json.dump({"arch": "mnist_cnn", "arch_props": MNIST4, "batch_size": 8}, open(cfg_path, "w"))
    save1, save2 = str(tmp_path / "m1.pt"), str(tmp_path / "m2.pt")
    for load, save in ((None, save1), (save1, save2)):
        load_opt = f"model-load-path={load} " if load else ""
        pipe = torch_parse(
            f"datareposrc location={data} json={meta} ! "
            f"tensor_trainer model-config={cfg_path} accelerator=cpu "
            f"model-save-path={save} {load_opt}"
            "num-inputs=1 num-labels=1 num-training-samples=8 "
            "num-validation-samples=0 epochs=1")
        pipe.run(timeout=120)
        assert os.path.exists(save)
    one, two = (torch.load(p, weights_only=True) for p in (save1, save2))
    assert any(not torch.equal(one[k], two[k]) for k in one)  # the second run trained on


def test_torch_tensor_frames_train_as_numpy_frames(tmp_path):
    """Frames that carry torch tensors train to the same step losses as
    the same samples carried as numpy arrays (on the card such frames are
    ordered after their producer's stream; here they lie on the CPU)."""
    rng = np.random.default_rng(6)
    samples = [(quadrant_image(rng, i % 4), np.int64([i % 4])) for i in range(16)]
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"arch": "mnist_cnn", "arch_props": MNIST4,
                                    "batch_size": 8}))
    losses = {}
    for kind, wrap in (("numpy", np.asarray), ("torch", torch.from_numpy)):
        ck = tmp_path / f"ck_{kind}"
        pipe = torch_parse(
            f"appsrc name=src ! tensor_trainer model-config={cfg_path} accelerator=cpu "
            f"num-inputs=1 num-labels=1 num-training-samples=16 epochs=1 checkpoint-path={ck} "
            "checkpoint-steps=2 ! tensor_sink")
        pipe.start()
        try:
            for img, label in samples:
                pipe["src"].push([wrap(img), wrap(label)])
            pipe["src"].end_of_stream()
            pipe.wait(timeout=60)
        finally:
            pipe.stop()
        losses[kind] = ckpt.load_meta(str(ck), 2)["cursor"]["ep_losses"]
    assert len(losses["torch"]) == 2 and losses["torch"] == losses["numpy"]


@pytest.mark.parametrize("prop,match", [
    ("model-save-path=m.msgpack", r"flax format.*\.pt"),
    ("model-load-path=m.msgpack", r"flax format.*\.pt"),
    ("mesh=dp:2", "ROADMAP A11"),
])
def test_refused_at_start(tmp_path, prop, match):
    pipe = torch_parse(
        "appsrc name=src ! tensor_trainer model-config={\"arch\":\"mnist_cnn\"} "
        f"accelerator=cpu {prop} ! tensor_sink")
    with pytest.raises(ElementError, match=match):
        pipe.start()
    pipe.stop()


def test_checkpoint_dir_and_model_file_serve_what_was_trained(tmp_path):
    """A trainer's ``checkpoint-path`` (its newest committed step) and its
    ``model-save-path`` file as ``torch-cuda`` model sources: logits equal
    to the trained weights' on the same frames.  A directory whose only
    step is torn, or that the JAX package wrote with orbax, is refused."""
    from nnstreamer_tpu.core import checkpoint as jax_ckpt

    data, meta = write_dataset(str(tmp_path), n=8)
    cfg_path = str(tmp_path / "cfg.json")
    json.dump({"arch": "mnist_cnn", "arch_props": MNIST4, "batch_size": 8}, open(cfg_path, "w"))
    ck_dir, save = tmp_path / "ck", tmp_path / "m.pt"
    torch_parse(f"datareposrc location={data} json={meta} ! tensor_trainer "
                f"model-config={cfg_path} accelerator=cpu model-save-path={save} "
                f"checkpoint-path={ck_dir} num-inputs=1 num-labels=1 num-training-samples=8 "
                "epochs=1").run(timeout=120)
    module, _, _ = torch_build("mnist_cnn", MNIST4)
    module.load_state_dict(torch.load(save, weights_only=True), strict=True)
    frames = np.random.default_rng(4).random((3, 28, 28, 1), np.float32)
    with torch.no_grad():
        want = module(torch.from_numpy(frames)).numpy()

    def served(model):
        pipe = torch_parse(f"appsrc name=src ! tensor_filter model={model} accelerator=cpu "
                           "framework=torch-cuda custom=arch:mnist_cnn,dtype:float32,classes:4,"
                           "seed:9 ! tensor_sink name=out")
        pipe.start()
        try:
            for x in frames:
                pipe["src"].push(x)
            pipe["src"].end_of_stream()
            pipe.wait(timeout=60)
        finally:
            pipe.stop()
        return np.stack([np.asarray(f.tensors[0]) for f in pipe["out"].frames])

    for model in (ck_dir, save):
        np.testing.assert_allclose(served(model), want, rtol=0, atol=1e-6)
    torn = tmp_path / "torn"
    ckpt.write_state(str(torn), 1, {"params": module.state_dict()})  # no marker
    jax_dir = tmp_path / "jax"
    jax_ckpt.save_state(str(jax_dir), 1, {"w": jnp.zeros(2)})
    for model, error, match in ((torn, FileNotFoundError, "no step_<N> directory has its"),
                                (jax_dir, ValueError, "orbax checkpoint written by the JAX")):
        with pytest.raises(error, match=match):
            served(model)


# -- the datarepo's edges (tests/test_media_ingest.py:310-410, test_wire_integrity.py:831-) --

def _datarepo(pkg):
    import importlib

    return (importlib.import_module(f"{pkg}.elements.datarepo"),
            importlib.import_module(f"{pkg}.pipeline.element").ElementError,
            importlib.import_module(f"{pkg}.core.buffer").TensorFrame)


PKGS = {"jax": "nnstreamer_tpu", "torch": "nnstreamer_tpu_torch"}


def test_image_repo_round_trip_equal_to_jax(tmp_path):
    """Image mode (a printf ``location``): both sinks write the same PNG
    files and meta; both sources read a shuffled sub-range alike."""
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 255, (6, 6, 3), np.uint8) for _ in range(5)]
    files = {}
    for pkg in PARSE:
        d = tmp_path / pkg
        d.mkdir()
        pipe = PARSE[pkg](f"appsrc name=src ! datareposink location={d}/s_%03d.png "
                          f"json={d}/meta.json")
        pipe.start()
        for img in imgs:
            pipe["src"].push(img)
        pipe["src"].end_of_stream()
        pipe.wait(timeout=20)
        pipe.stop()
        files[pkg] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert files["torch"] == files["jax"] and len(files["torch"]) == 6
    extra = "start-sample-index=1 stop-sample-index=3 is-shuffle=true shuffle-seed=4"
    got = read_frames("torch", f"{tmp_path}/torch/s_%03d.png", f"{tmp_path}/torch/meta.json",
                      extra)
    assert_same_frames(got, read_frames("jax", f"{tmp_path}/jax/s_%03d.png",
                                        f"{tmp_path}/jax/meta.json", extra))
    assert sorted(f.meta["sample_index"] for f in got) == [1, 2, 3]
    for f in got:
        np.testing.assert_array_equal(np.asarray(f.tensors[0]), imgs[f.meta["sample_index"]])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_sink_refuses_what_it_cannot_read_back(tmp_path, pkg):
    repo, error, frame = _datarepo(PKGS[pkg])
    sink = repo.DataRepoSink()
    sink.props["location"] = str(tmp_path / "s_%03d.png")
    sink.props["json"] = str(tmp_path / "m.json")
    sink.start()
    sink.render(frame([np.zeros((6, 6, 3), np.uint8)]))
    with pytest.raises(error, match="differs"):
        sink.render(frame([np.zeros((8, 8, 3), np.uint8)]))
    with pytest.raises(error, match="uint8"):
        sink.render(frame([np.zeros((6, 6), np.uint8)]))  # 2-D
    flat = repo.DataRepoSink()
    flat.props["location"] = str(tmp_path / "data_50%.bin")  # a literal percent: flat
    flat.props["json"] = str(tmp_path / "flat.json")
    flat.start()
    flat.render(frame([np.ones((4,), np.float32)]))
    flat.stop()
    meta = json.load(open(tmp_path / "flat.json"))
    assert meta["format"] == "static" and meta["total_samples"] == 1
    for pat, idx, want in (("img_%02ld.png", 3, "img_03.png"),
                           ("img_%04lld.png", 7, "img_0007.png"),
                           ("img_%lld.png", 12, "img_12.png")):
        assert repo._is_image_pattern(pat) and repo._fmt_sample_path(pat, idx) == want


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_killed_writer_and_truncated_repos(tmp_path, pkg):
    """A writer killed before ``stop()`` leaves the published repo as it
    was; a file ending mid-sample serves its complete prefix, counted; a
    file with no complete sample, or an image repo missing a sample, fails
    at ``start()``."""
    repo, error, frame = _datarepo(PKGS[pkg])
    data, meta = tmp_path / "d.bin", tmp_path / "d.json"
    pipe = PARSE[pkg](f"appsrc name=src ! datareposink location={data} json={meta}")
    pipe.start()
    for i in range(4):
        pipe["src"].push(np.full((2,), i, np.float32))
    pipe["src"].end_of_stream()
    pipe.wait(timeout=20)
    pipe.stop()
    before = data.read_bytes()
    sink = repo.DataRepoSink("s")
    sink.set_property("location", str(data))
    sink.set_property("json", str(meta))
    sink.start()
    sink.render(frame([np.float32([9.0, 9.0])]))  # no stop(): killed
    assert data.read_bytes() == before and json.loads(meta.read_text())["total_samples"] == 4
    data.write_bytes(before[: 2 * 8 + 3])
    pipe = PARSE[pkg](f"datareposrc name=r location={data} json={meta} ! tensor_sink name=out")
    pipe.start()
    pipe.wait(timeout=20)
    assert [float(np.asarray(f.tensors[0])[0]) for f in pipe["out"].frames] == [0.0, 1.0]
    assert pipe.health()["r"]["truncated_samples"] == 2
    pipe.stop()
    data.write_bytes(b"\x00" * 3)
    src = repo.DataRepoSrc("r")
    src.set_property("location", str(data))
    src.set_property("json", str(meta))
    with pytest.raises(error, match="no complete sample"):
        src.start()
    (tmp_path / "img.json").write_text(json.dumps(
        {"format": "image", "tensors": ["uint8:6:8:3"], "total_samples": 2}))
    from nnstreamer_tpu_torch.media.image import write_image

    write_image(str(tmp_path / "img_00.png"), np.zeros((8, 6, 3), np.uint8))
    src = repo.DataRepoSrc("r")
    src.set_property("location", str(tmp_path / "img_%02d.png"))
    src.set_property("json", str(tmp_path / "img.json"))
    with pytest.raises(error, match="missing"):
        src.start()
