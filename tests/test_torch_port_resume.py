"""Mid-epoch resume of the port's trainers (train/loop.py `fit`,
train/scan.py `fit_cached`), each final state bitwise the unbroken run's:

  * the streaming `fit` on the keyed `pallas` step (its plain version on
    the CPU), the `xla` step and `--dropout_rng torch`'s masked step, all
    through the captured loop's buffers (run eagerly on the CPU): a run
    resumed from any of its step checkpoints ends on the unbroken run's
    params, key and losses, and saves the same states after;
  * `fit_cached`: chunked (`ckpt_every_steps`) equal to unchunked, then a
    chunked resume, on `xla`, `pallas` and `pallas_rng`;
  * the 4-replica CPU mesh with the int8 strategy and error feedback, its
    residual carried by the checkpoint;
  * a piped resume (2 decode workers, depth 2) bitwise the unpiped run;
  * the port's checkpoint at step K against the JAX package's `fit` and
    `fit_cached` hooks at the same K: key words, epoch and offset equal,
    params within rtol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.data.loader import BatchLoader as JaxLoader
from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.parallel.sampler import ShardedSampler as JaxSampler
from pytorch_ddp_mnist_tpu.train import loop as jax_loop
from pytorch_ddp_mnist_tpu.train import scan as jax_scan
from pytorch_ddp_mnist_tpu_torch.data.loader import BatchLoader
from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images, synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params
from pytorch_ddp_mnist_tpu_torch.ops import fused_step
from pytorch_ddp_mnist_tpu_torch.ops.threefry import key_data
from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
from pytorch_ddp_mnist_tpu_torch.train import loop, scan

N, B, EPOCHS, EVERY, LR = 192, 32, 2, 2, 0.05   # 6 steps an epoch
S = N // B
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data():
    split = synthetic_mnist(N, 4)
    test = synthetic_mnist(64, 5)
    tree = jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(0)))
    return {"images": split.images, "x": normalize_images(split.images),
            "y": split.labels.astype(np.int32),
            "xt": normalize_images(test.images),
            "yt": test.labels.astype(np.int32), "tree": tree}


def _snap(model):
    return {n: {k: v.detach().clone() for k, v in layer.items()}
            for n, layer in model.params().items()}


def _load(model, params):
    with torch.no_grad():
        for n, layer in model.params().items():
            for k, v in layer.items():
                v.copy_(params[n][k])


def _equal(a, b):
    return all(torch.equal(a[n][k], b[n][k]) for n in a for k in a[n])


def _recorder(saves):
    def hook(epoch, offset, step, st):
        saves.append({"epoch": epoch, "offset": offset, "step": step,
                      "key": tuple(st.key), "params": _snap(st.model),
                      "resid": (None if st.resid is None
                                else st.resid.detach().clone())})
    return hook


STEPS = {
    "xla": lambda skip: loop.make_train_step(LR),
    "pallas": lambda skip: fused_step.make_fused_train_step(LR),
    "torch_dropout": lambda skip: loop.make_torch_dropout_train_step(
        LR, 0, skip_steps=skip, batch_size=B),
}


def _stream(data, kind, start=None, workers=0, depth=1):
    model = from_jax_params(data["tree"])
    key, epoch, offset = key_data(1), 0, 0
    if start is not None:
        _load(model, start["params"])
        key, epoch, offset = start["key"], start["epoch"], start["offset"]
    saves = []
    state, hist = loop.fit(
        loop.TrainState(model, key),
        BatchLoader(data["x"], data["y"], ShardedSampler(N, seed=42), B),
        data["xt"], data["yt"], epochs=EPOCHS, batch_size=B,
        train_step=STEPS[kind](epoch * S + offset), start_epoch=epoch,
        start_offset=offset, ckpt_every_steps=EVERY,
        step_hook=_recorder(saves), input_workers=workers,
        prefetch_depth=depth, log=lambda line: None)
    return state, hist, saves


def _check_resume(golden, resumed, start, steps=S):
    (g_state, g_hist, g_saves), (r_state, r_hist, r_saves) = golden, resumed
    assert _equal(_snap(r_state.model), _snap(g_state.model))
    assert r_state.key == g_state.key
    tail = np.concatenate(g_hist)[start["epoch"] * steps + start["offset"]:]
    np.testing.assert_array_equal(np.concatenate(r_hist), tail)
    later = [s for s in g_saves if s["step"] > start["step"]]
    assert [(s["epoch"], s["offset"], s["step"], s["key"]) for s in r_saves] \
        == [(s["epoch"], s["offset"], s["step"], s["key"]) for s in later]
    assert all(_equal(a["params"], b["params"])
               for a, b in zip(r_saves, later))


@pytest.mark.parametrize("kind", list(STEPS))
def test_streaming_resume_from_a_step_checkpoint_is_the_unbroken_run(data,
                                                                     kind):
    golden = _stream(data, kind)
    saves = golden[2]
    # the cadence: every 2 steps of an epoch and its last, the last one
    # normalised to the next epoch's start
    assert [(s["epoch"], s["offset"], s["step"]) for s in saves] == [
        (0, 2, 2), (0, 4, 4), (1, 0, 6), (1, 2, 8), (1, 4, 10), (2, 0, 12)]
    for start in (saves[1], saves[2], saves[3]):
        _check_resume(golden, _stream(data, kind, start), start)


def test_piped_resume_is_the_unpiped_run(data):
    golden = _stream(data, "pallas")
    start = golden[2][3]                       # epoch 1, offset 2
    _check_resume(golden, _stream(data, "pallas", start, workers=2,
                                  depth=2), start)


def _cached(data, kernel, every, start=None, mesh=None, comm="pmean",
            n=N):
    model = from_jax_params(data["tree"])
    key, epoch, offset, resid = key_data(1), 0, 0, None
    if start is not None:
        _load(model, start["params"])
        key, epoch, offset = start["key"], start["epoch"], start["offset"]
        resid = start["resid"]
    saves = []
    key, hist = scan.fit_cached(
        model, key, data["images"][:n], data["y"][:n],
        ShardedSampler(n, seed=42),
        data["xt"], data["yt"], epochs=EPOCHS, batch_size=B, lr=LR,
        kernel=kernel, mesh=mesh, comm=comm, start_epoch=epoch,
        start_offset=offset, ckpt_every_steps=every,
        step_hook=_recorder(saves) if every else None, resid=resid,
        log=lambda line: None)
    comm_state = scan.fit_cached.comm
    state = loop.TrainState(model, key, None if comm_state is None
                            else comm_state.resid)
    return state, hist, saves


@pytest.mark.parametrize("kernel", ["xla", "pallas", "pallas_rng"])
def test_cached_chunks_are_the_unchunked_epoch_then_resume(data, kernel):
    whole = _cached(data, kernel, 0)
    golden = _cached(data, kernel, EVERY)
    assert _equal(_snap(golden[0].model), _snap(whole[0].model))
    assert golden[0].key == whole[0].key
    np.testing.assert_array_equal(np.concatenate(golden[1]),
                                  np.concatenate(whole[1]))
    for start in (golden[2][1], golden[2][3]):
        _check_resume(golden, _cached(data, kernel, EVERY, start), start)


def test_int8_mesh_resume_carries_the_residual(data):
    mesh, n = (CPU,) * 4, 4 * B        # 4 steps an epoch
    golden = _cached(data, "xla", EVERY - 1, mesh=mesh, comm="int8", n=n)
    start = golden[2][4]               # epoch 1, offset 1
    assert (start["epoch"], start["offset"]) == (1, 1)
    assert start["resid"] is not None and start["resid"].abs().sum() > 0
    resumed = _cached(data, "xla", EVERY - 1, start, mesh=mesh, comm="int8",
                      n=n)
    _check_resume(golden, resumed, start, steps=4)
    assert torch.equal(resumed[0].resid, golden[0].resid)
    assert all(torch.equal(a["resid"], b["resid"]) for a, b in zip(
        resumed[2], [s for s in golden[2] if s["step"] > start["step"]]))


def _jax_saves(data, cached):
    saves = []

    def hook(epoch, offset, step, st):
        saves.append({"epoch": epoch, "offset": offset, "step": step,
                      "key": tuple(int(w) for w in np.asarray(
                          jax.random.key_data(st.key))),
                      "params": jax.tree_util.tree_map(np.asarray,
                                                       st.params)})

    state = jax_loop.TrainState(init_mlp(jax.random.key(0)),
                                jax.random.key(1))
    kw = dict(epochs=EPOCHS, batch_size=B, lr=LR, ckpt_every_steps=EVERY,
              step_hook=hook, log=lambda line: None)
    if cached:
        jax_scan.fit_cached(state, data["images"], data["y"],
                            JaxSampler(N, seed=42), data["xt"], data["yt"],
                            kernel="xla", **kw)
    else:
        jax_loop.fit(state, JaxLoader(data["x"], data["y"],
                                      JaxSampler(N, seed=42), B),
                     data["xt"], data["yt"], **kw)
    return saves


@pytest.mark.parametrize("cached", [False, True])
def test_the_checkpoint_at_step_k_is_the_jax_package_s(data, cached):
    ours = (_cached(data, "xla", EVERY) if cached else
            _stream(data, "xla"))[2]
    theirs = _jax_saves(data, cached)
    assert [(s["epoch"], s["offset"], s["step"], s["key"]) for s in ours] \
        == [(s["epoch"], s["offset"], s["step"], s["key"]) for s in theirs]
    for a, b in zip(ours, theirs):
        for n in b["params"]:
            for k in b["params"][n]:
                np.testing.assert_allclose(a["params"][n][k].numpy(),
                                           b["params"][n][k], rtol=1e-5,
                                           atol=1e-7)


def test_resume_refuses_what_jax_refuses(data):
    with pytest.raises(ValueError, match="start_offset=6 >= the epoch's 6"):
        _stream(data, "xla", {"params": _snap(from_jax_params(data["tree"])),
                              "key": key_data(1), "epoch": 0, "offset": 6})
    with pytest.raises(ValueError, match="start_epoch=3 outside"):
        loop.fit(loop.TrainState(from_jax_params(data["tree"]), key_data(1)),
                 BatchLoader(data["x"], data["y"], ShardedSampler(N), B),
                 data["xt"], data["yt"], epochs=2, batch_size=B, lr=LR,
                 start_epoch=3)
