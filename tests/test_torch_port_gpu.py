"""The port's CUDA kernels on a card. Every test here is marked `gpu` and
skips, from inside its fixture, where torch.cuda.is_available() is False:
a kernel has no CPU mode. The file imports neither jax nor the JAX package,
so it also runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_port_gpu.py -m gpu --noconftest -q

Tolerances are the JAX package's pins for its fused step
(tests/test_pallas_step.py): loss rtol 1e-5, grads rtol 2e-4 / atol 1e-6;
two launches on the same inputs must be bitwise equal (no atomics). The
whole-epoch kernel (K2) is held bitwise against K1 + SGD per step (the
same row and gradient code), its in-kernel masks bitwise against the plain
streams, and against its plain version: losses at rtol 1e-5 / atol 1e-6,
params in relative Frobenius norm 1e-3 (per element, a ReLU input within
rounding of 0 may take the other branch in one of the two summation
orders; chip_smoke.py PARAM_FRO_RTOL says more). K6, the DP epoch
kernel's ring, is held on an n-replica mesh on one card: every replica's
weights bitwise equal after the launch, bitwise equal to K1 per replica +
the ring's summation tree + SGD (the same row and gradient code), a
1-replica ring launch bitwise equal to K2, and a stalled ring ending in
RingTimeoutError. K2-ws, the weight-stationary design of K2's uint8 f32
forms, is held bitwise against the rows design on the same inputs and
against K1 + SGD, its superstep bitwise against K = 1 on a ragged epoch,
its normalise table bitwise against the plain normalise, and its stamps
build bitwise against the default build. K1-split, the split design of
K1's f32 forms, is held bitwise against K1's rows design (the loss and all
five gradients) at B = 128, 96, 8 and 3 with a mask and with the in-kernel
draw, on an odd-offset view and in a CUDA-graph replay, its stamps build
against its default build, and the cached trainer's losses on it against
the same run on the rows design. K1-mma, the mma design of K1's bf16 forms
(the products on the tensor cores, summed in their order), is held at the
JAX package's bf16 pins against the plain version and against the rows
design at B = 128, 96, 8 and 3 with a mask and with the in-kernel draw, a
repeat launch and a CUDA-graph replay bitwise equal to the first call, the
Philox form bitwise the mask form on philox.rng_mask, on an odd-offset view
and 48 distinct inputs, its stamps build bitwise its default build, and
the cached bf16 trainer's losses on it against the rows design's. K2-mma,
the tensor-core design of K2's uint8 bf16 forms (csrc/epoch_mma.cu: K1-mma's
phases in one cooperative launch, SGD folded in), is held bitwise against
K1-mma + SGD per step and a repeat launch at B = 128, 96 and 8 in the masks,
Philox and threefry forms, at the JAX bf16 pins against its plain version
and the rows design, its superstep bitwise K = 1, its stamps build bitwise
its default build. The rows design's K2-bf16 stays bitwise the rows
design's K1-bf16 + SGD, and the K6-bf16 pin names that step too. K6-ws,
the DP rings on K2-ws's column-owner step (csrc/ring_ws.cu, one mini-ring
per column owner), is held bitwise against the rows design's ring and K1
per replica + the ring tree + SGD at B = 128, 96 and 8 on both rings,
with the replicas in lockstep and a repeat launch bitwise; its 1-replica
launch bitwise K2-ws, K2-ws at four units a block bitwise two, its
constants and co-residency, its stamps build bitwise its default build,
and a stalled ring of either design raising by name. K6-mma, the DP rings'
bf16 forms on K2-mma's tensor-core step (csrc/ring_mma.cu, one mini-ring
per gradient-tile owner), is held bitwise against K1-mma per replica + the
ring tree + SGD at B = 128, 96 and 8 on both rings at n = 2, 3, 4, with
the replicas in lockstep and a repeat launch bitwise, at the JAX bf16 pins
against its plain version and the rows design's ring in bf16 forced; its
1-replica launch bitwise K2-mma, its constants and co-residency, its
stamps build bitwise its default build, a stalled ring raising by name,
and the bf16 DP scan on a card mesh launching it and tracking the CPU
mesh. The keyed forms of K1-split and K1-mma (jax's threefry mask drawn in
the hidden phase, the key read from a device table) are held bitwise
against their mask-input forms on the mask entry's mask at B = 128, 96
and 3, with keys whose words have the high bit set; the keyed rows step
past 128 rows launches the mask entry; a captured keyed call reads the key
the table holds when it replays; their stamps builds, the refusals of a
null or misaligned key, and a cached `pallas` epoch that launches no mask
entry. The per-step loops captured as CUDA graphs (train/graphs.py; `-k
graph`): each cached path (`xla`, `pallas`, `pallas_rng` in f32 and bf16,
a 4-replica mesh of the card) and the streaming `fit` (`pallas`, `xla`)
bitwise the same step run eagerly on the same buffers, in losses and
params, with one capture a run and the eager run's launch counts; a
replay on new indices and keys bitwise the eager epoch on them; K1-rng's
device-seed forms (K1-split, K1-mma, the rows design) bitwise their
scalar-seed forms, and a replay after the seed word changes drawing the
new seed's mask; a body that syncs inside capture raising by name; a
world of one rank (a WorldMesh, over gloo and over NCCL), cached and
streaming, on the eager loop with no capture, bitwise the captured
1-replica mesh. The eager side of each pin is the loop built with
`eager=True` (scan.CachedSteps, loop._captured_steps); no entry point
takes it."""

import ctypes
import re
from functools import partial

import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu_torch.cli import train as port_cli
from pytorch_ddp_mnist_tpu_torch.data.mnist import (device_normalize,
                                                     normalize_images,
                                                     synthetic_mnist)
from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
from pytorch_ddp_mnist_tpu_torch.ops import (epoch_step, fused_step, philox,
                                             threefry)
from pytorch_ddp_mnist_tpu_torch.ops.sgd import sgd_step
from pytorch_ddp_mnist_tpu_torch.parallel.ddp import make_dp_train_step
from pytorch_ddp_mnist_tpu_torch.train import scan
from pytorch_ddp_mnist_tpu_torch.train.loop import make_train_step

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(batch, seed, device):
    split = synthetic_mnist(batch, seed=seed)
    rng = np.random.default_rng(seed)
    mask = (rng.random((batch, 128)) < 0.8).astype(np.float32) / np.float32(0.8)
    model = MLP(torch.Generator().manual_seed(seed)).to(device)
    return (model.params(),
            torch.from_numpy(normalize_images(split.images)).to(device),
            torch.from_numpy(split.labels.astype(np.int32)).to(device),
            torch.from_numpy(mask).to(device))


def _k1_key(x, rng=False, keyed=False):
    """The launch_count key a K1 call on x counts under: its design's (the
    keyed form's: the `--kernel pallas` step's)."""
    design = fused_step.fused_design(x.dtype, rng, x.shape[0])
    if design != "rows":
        return (f"fused_{design}" + ("_rng" if rng else "")
                + ("_keyed" if keyed else ""))
    return ("fused_step" + ("_rng" if rng else "")
            + ("_bf16" if x.dtype == torch.bfloat16 else ""))


def _k1_leaves(loss, grads):
    return [loss] + [grads[n][k] for n in grads for k in grads[n]]


@pytest.mark.parametrize("batch", [128, 1000, 700, 3])
def test_kernel_matches_its_plain_version_and_repeats_bitwise(cuda, batch):
    args = _inputs(batch, batch, cuda)
    key = _k1_key(args[1])
    before = fused_step.launch_count[key]
    loss, grads = fused_step.fused_loss_and_grads(*args)
    loss2, grads2 = fused_step.fused_loss_and_grads(*args)
    assert fused_step.launch_count[key] == before + 2
    ref_loss, ref_grads = fused_step.fused_loss_and_grads_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(loss, loss2)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=0)
    for n in ref_grads:
        for k in ref_grads[n]:
            assert grads[n][k].shape == ref_grads[n][k].shape
            assert torch.equal(grads[n][k], grads2[n][k]), f"{n}.{k}"
            torch.testing.assert_close(grads[n][k], ref_grads[n][k],
                                       rtol=2e-4, atol=1e-6, msg=f"{n}.{k}")


def test_wrapper_rejects_a_tensor_on_another_device(cuda):
    params, x, y, mask = _inputs(8, 0, cuda)
    with pytest.raises(ValueError, match="scaled_mask"):
        fused_step.fused_loss_and_grads(params, x, y, mask.cpu())


def test_fused_step_tracks_the_autograd_step_on_card(cuda):
    # same seeds -> same weights and the same dropout masks on both paths
    split = synthetic_mnist(512, 3)
    x = torch.from_numpy(normalize_images(split.images)).to(cuda)
    y = torch.from_numpy(split.labels.astype(np.int32)).to(cuda)
    runs = []
    for step in (make_train_step(0.01), fused_step.make_fused_train_step(0.01)):
        model = MLP(torch.Generator().manual_seed(0)).to(cuda)
        key = threefry.key_data(1)
        k1 = _k1_key(x[:128], keyed=True)
        before = fused_step.launch_count[k1]
        losses = []
        for i in range(0, 512, 128):
            key, loss = step(model, key, x[i:i + 128], y[i:i + 128])
            losses.append(loss)
        losses = torch.stack(losses)
        runs.append((losses.cpu(), fused_step.launch_count[k1] - before,
                     model))
    (plain, plain_launches, _), (fused, fused_launches, model) = runs
    assert (plain_launches, fused_launches) == (0, 4)
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=0)
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_cli_trains_through_the_kernel(cuda, tmp_path, capsys):
    key = "fused_split_keyed"    # f32 at B = 64: the split design, keyed
    before = dict(fused_step.launch_count)
    rc = port_cli.main(["--limit", "512", "--batch_size", "64",
                        "--checkpoint", str(tmp_path / "m.pt"),
                        "--path", str(tmp_path / "no_mnist")])
    out = capsys.readouterr().out
    assert rc == 0 and "kernel=pallas" in out
    assert re.search(r"^Epoch=0, train_loss=\S+, val_loss=\S+", out, re.M)
    assert fused_step.launch_count[key] == before[key] + 512 // 64
    # the mask is drawn in the kernel: no launch of the mask entry
    assert fused_step.launch_count["threefry_mask"] == before["threefry_mask"]
    assert (tmp_path / "m.pt").exists()


# ---- K2, the whole-epoch kernel ----

K2_FORMS = {"K2a": ("f32", "masks"), "K2b": ("uint8", "masks"),
            "K2c": ("uint8", "core"), "K3": ("uint8", "threefry")}


def _epoch_inputs(batch, nsteps, seed, device):
    rows = batch * nsteps
    split = synthetic_mnist(rows, seed=seed)
    rng = np.random.default_rng(seed)
    masks = (rng.random((rows, 128)) < 0.8).astype(np.float32) / np.float32(0.8)
    model = MLP(torch.Generator().manual_seed(seed)).to(device)
    return {
        "params": {n: {k: v.detach() for k, v in layer.items()}
                   for n, layer in model.params().items()},
        "uint8": torch.from_numpy(split.images.reshape(rows, -1)).to(device),
        "f32": torch.from_numpy(normalize_images(split.images)).to(device),
        "y": torch.from_numpy(split.labels.astype(np.int32)).to(device),
        "masks": torch.from_numpy(masks).to(device),
        "threefry": threefry.to_int32_words(
            threefry.split(threefry.key_data(seed), nsteps)).to(device),
        "core": int(rng.integers(0, 2**32)), "batch": batch,
    }


def _epoch(fn, form, inp):
    pixels, rng = K2_FORMS[form]
    return fn(inp["params"], inp[pixels], inp["y"],
              None if rng == "masks" else inp[rng], 0.01, inp["batch"],
              masks=inp["masks"] if rng == "masks" else None,
              rng_impl="threefry" if rng == "threefry" else "core")


def _k1_epoch(form, inp):
    pixels, rng = K2_FORMS[form]
    batch = inp["batch"]
    params = {n: {k: t.clone() for k, t in layer.items()}
              for n, layer in inp["params"].items()}
    losses = []
    for s in range(inp["y"].shape[0] // batch):
        rows = slice(s * batch, (s + 1) * batch)
        x = inp[pixels][rows]
        x = device_normalize(x) if pixels == "uint8" else x
        mask = epoch_step.step_mask(rng, inp[rng], inp["masks"], s, batch,
                                    x.device)
        loss, grads = fused_step.fused_loss_and_grads(params, x,
                                                      inp["y"][rows], mask)
        sgd_step(params, grads, 0.01)
        losses.append(loss)
    return params, torch.stack(losses)


def _leaves(params, losses):
    return [losses] + [t for layer in params.values() for t in layer.values()]


@pytest.mark.parametrize("form", list(K2_FORMS))
@pytest.mark.parametrize("batch,nsteps", [(128, 24), (8, 5)])
def test_epoch_kernel_matches_k1_bitwise_and_its_plain_version(cuda, form,
                                                               batch, nsteps):
    inp = _epoch_inputs(batch, nsteps, seed=batch + nsteps, device=cuda)
    design = epoch_step.epoch_design(inp[K2_FORMS[form][0]].dtype, False,
                                     batch)
    key = "epoch_step_ws" if design == "ws" else "epoch_step"
    before = epoch_step.launch_count[key]
    got = _leaves(*_epoch(epoch_step.epoch_fused_sgd, form, inp))
    again = _leaves(*_epoch(epoch_step.epoch_fused_sgd, form, inp))
    assert epoch_step.launch_count[key] == before + 2
    assert epoch_step.last_launch["form"] == "/".join(K2_FORMS[form])
    assert epoch_step.last_launch["design"] == design
    k1 = _leaves(*_k1_epoch(form, inp))
    ref = _leaves(*_epoch(epoch_step.epoch_fused_sgd_reference, form, inp))
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, k1):
        assert torch.equal(a, b) and torch.equal(a, c)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-6)
    for a, r in zip(got[1:], ref[1:]):
        assert float((a - r).norm() / r.norm()) <= 1e-3


@pytest.mark.parametrize("impl", ["core", "threefry"])
def test_in_kernel_masks_are_the_plain_streams_bitwise(cuda, impl):
    inp = _epoch_inputs(64, 6, seed=3, device=cuda)
    rng = "core" if impl == "core" else "threefry"
    for step in range(6):
        km = epoch_step.kernel_mask_block(inp[rng], step, 64, rng_impl=impl,
                                          device=cuda)
        pm = epoch_step.step_mask(rng, inp[rng], None, step, 64, cuda)
        assert torch.equal(km, pm)


def test_cached_cli_runs_one_epoch_kernel_launch_per_epoch(cuda, tmp_path,
                                                           capsys):
    before = dict(epoch_step.launch_count)
    rc = port_cli.main(["--cached", "--fused", "--kernel", "pallas_epoch",
                        "--n_epochs", "2", "--limit", "1024",
                        "--checkpoint", str(tmp_path / "m.pt"),
                        "--path", str(tmp_path / "no_mnist")])
    out = capsys.readouterr().out
    assert rc == 0 and "kernel=pallas_epoch cached fused" in out
    assert re.search(r"^Epoch=1, train_loss=\S+, val_loss=\S+", out, re.M)
    assert epoch_step.launch_count["epoch_step_ws"] == \
        before["epoch_step_ws"] + 2
    assert epoch_step.last_launch["design"] == "ws"


# ---- slice 3: K1-bf16, K1-rng, K2-bf16, K2 superstep, the streaming mask ----
#
# bf16 tolerances are the JAX package's pins for its bf16 kernels against
# step_reference_bf16 (tests/test_pallas_step.py): loss rtol 1e-3, grads
# rtol 2e-3 / atol 1e-4; over a multi-step epoch, losses rtol 1e-3 / atol
# 1e-4 and params 2e-3 in relative Frobenius norm (a bf16 rounding that
# flips in the other summation order moves a value by 2**-8 of itself).

def _bf16_close(got, ref):
    loss, grads = got
    ref_loss, ref_grads = ref
    torch.testing.assert_close(loss, ref_loss, rtol=1e-3, atol=0)
    for n in ref_grads:
        for k in ref_grads[n]:
            torch.testing.assert_close(grads[n][k], ref_grads[n][k],
                                       rtol=2e-3, atol=1e-4, msg=f"{n}.{k}")


@pytest.mark.parametrize("batch", [128, 1000, 3])
def test_bf16_kernel_matches_its_plain_version(cuda, batch):
    params, x, y, mask = _inputs(batch, batch, cuda)
    xb = x.to(torch.bfloat16)
    key = _k1_key(xb)       # the mma design at B <= 128, rows past it
    before = dict(fused_step.launch_count)
    got = fused_step.fused_loss_and_grads(params, xb, y, mask)
    again = fused_step.fused_loss_and_grads(params, xb, y, mask)
    f32 = fused_step.fused_loss_and_grads(params, x, y, mask)
    assert fused_step.launch_count[key] == before[key] + 2
    ref = fused_step.step_reference_bf16(params, xb, y, mask)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0])
    for n in got[1]:
        for k in got[1][n]:
            assert torch.equal(got[1][n][k], again[1][n][k])
    _bf16_close(got, ref)
    assert not torch.equal(got[0], f32[0])


@pytest.mark.parametrize("batch", [128, 600, 3])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_rng_kernel_draws_the_philox_blocks_and_matches_plain(cuda, batch,
                                                              bf16):
    params, x, y, _ = _inputs(batch, batch, cuda)
    x = x.to(torch.bfloat16) if bf16 else x
    seed = (1 << 31) + batch
    km = fused_step.kernel_rng_mask(seed, batch, cuda)
    assert torch.equal(km, philox.rng_mask(seed, batch, cuda))
    got = fused_step.fused_loss_and_grads_rng(params, x, y, seed)
    again = fused_step.fused_loss_and_grads_rng(params, x, y, seed)
    other = fused_step.fused_loss_and_grads_rng(params, x, y, seed + 1)
    ref = (fused_step.step_reference_bf16 if bf16 else
           fused_step.fused_loss_and_grads_reference)(params, x, y, km)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and not torch.equal(got[0], other[0])
    if bf16:
        _bf16_close(got, ref)
    else:
        torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=0)
        for n in ref[1]:
            for k in ref[1][n]:
                torch.testing.assert_close(got[1][n][k], ref[1][n][k],
                                           rtol=2e-4, atol=1e-6)


def test_streaming_mask_is_the_threefry_draw(cuda):
    for seed in (0, 7, (1 << 31) + 3):
        key = threefry.split(threefry.key_data(seed))[1]
        for batch in (128, 3):
            before = fused_step.launch_count["threefry_mask"]
            got = fused_step.dropout_mask(key, batch, cuda)
            assert fused_step.launch_count["threefry_mask"] == before + 1
            assert torch.equal(got.cpu(),
                               threefry.dropout_mask(key, batch, "cpu"))


def _k1_epoch_bf16(form, inp, design=None):
    """The epoch as K1-bf16 + SGD per step: on K1's own design at this
    batch (K1-mma at B <= 128, the step K2-mma computes), or on the rows
    design (`design="rows"`, the step csrc/epoch_step.cu computes)."""
    pixels, rng = K2_FORMS[form]
    batch = inp["batch"]
    params = {n: {k: t.clone() for k, t in layer.items()}
              for n, layer in inp["params"].items()}
    losses = []
    for s in range(inp["y"].shape[0] // batch):
        rows = slice(s * batch, (s + 1) * batch)
        x = inp[pixels][rows]
        x = (device_normalize(x) if pixels == "uint8" else x).to(torch.bfloat16)
        mask = epoch_step.step_mask(rng, inp[rng], inp["masks"], s, batch,
                                    x.device)
        loss, grads = fused_step.fused_loss_and_grads(
            params, x, inp["y"][rows], mask, _design=design)
        sgd_step(params, grads, 0.01)
        losses.append(loss)
    return params, torch.stack(losses)


@pytest.mark.parametrize("form", list(K2_FORMS))
def test_bf16_epoch_kernel_matches_k1_bf16_bitwise_and_plain(cuda, form):
    # the uint8 forms run K2-mma, bitwise K1-mma + SGD; K2a (f32 rows) the
    # rows design, bitwise the rows design's K1-bf16 + SGD
    inp = _epoch_inputs(128, 12, seed=5, device=cuda)
    design = epoch_step.epoch_design(inp[K2_FORMS[form][0]].dtype, True, 128)
    assert design == ("rows" if form == "K2a" else "mma")
    key = "epoch_step_mma" if design == "mma" else "epoch_step_bf16"
    before = epoch_step.launch_count[key]
    got = _leaves(*_epoch(partial(epoch_step.epoch_fused_sgd,
                                  compute_bf16=True), form, inp))
    assert epoch_step.last_launch["design"] == design
    again = _leaves(*_epoch(partial(epoch_step.epoch_fused_sgd,
                                    compute_bf16=True), form, inp))
    assert epoch_step.launch_count[key] == before + 2
    k1 = _leaves(*_k1_epoch_bf16(form, inp,
                                 None if design == "mma" else "rows"))
    ref = _leaves(*_epoch(partial(epoch_step.epoch_fused_sgd_reference,
                                  compute_bf16=True), form, inp))
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, k1):
        assert torch.equal(a, b) and torch.equal(a, c)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-3, atol=1e-4)
    for a, r in zip(got[1:], ref[1:]):
        assert float((a - r).norm() / r.norm()) <= 2e-3


@pytest.mark.parametrize("form", ["K2a", "K2c", "K3"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_superstep_is_bitwise_k1_on_a_ragged_epoch(cuda, form, bf16):
    inp = _epoch_inputs(64, 11, seed=9, device=cuda)
    fn = partial(epoch_step.epoch_fused_sgd, compute_bf16=bf16)
    base = _leaves(*_epoch(fn, form, inp))
    for k in (2, 4, 8):
        got = _leaves(*_epoch(partial(fn, steps_per_iter=k), form, inp))
        ll = epoch_step.last_launch
        assert ll["steps_per_iter"] == k
        # the 'rows' design stages uint8 rows; K2-ws (uint8, f32) and
        # K2-mma (uint8, bf16) need not
        assert ll["design"] == ("rows" if form == "K2a" else
                                "mma" if bf16 else "ws")
        assert ll["staged"] == (ll["design"] == "rows" and form != "K2a")
        assert got[0].shape == (11,)
        for a, b in zip(got, base):
            assert torch.equal(a, b), (form, bf16, k)


@pytest.mark.parametrize("batch", [64, 256])
@pytest.mark.parametrize("form", ["K2c", "K3"])
def test_rows_design_bf16_superstep_stages_uint8_rows_bitwise_k1(cuda, form,
                                                                 batch):
    # the rows design's bf16 superstep: the rule's pick at B > 128 (the
    # bench's --batch_size 256), forced at B = 64; it stages its uint8 rows
    assert epoch_step.epoch_design(torch.uint8, True, batch) == (
        "rows" if batch > 128 else "mma")
    inp = _epoch_inputs(batch, 11, seed=9, device=cuda)
    fn = partial(epoch_step._epoch_fused_sgd_rows, compute_bf16=True)
    base = _leaves(*_epoch(fn, form, inp))
    for k in (2, 4, 8):
        if k * batch > epoch_step.EPOCH_KERNEL_MAX_BATCH:
            continue
        got = _leaves(*_epoch(partial(fn, steps_per_iter=k), form, inp))
        ll = epoch_step.last_launch
        assert (ll["design"], ll["staged"], ll["steps_per_iter"]) == (
            "rows", True, k)
        assert got[0].shape == (11,)
        for a, b in zip(got, base):
            assert torch.equal(a, b), (form, batch, k)


# ---- slice 4: K6, the DP epoch kernel's ring, on a replica mesh of one card ----

RING_CASES = [("allgather", 2), ("allgather", 4), ("reduce_scatter", 3),
              ("reduce_scatter", 4)]
DP_FORMS = ("K2b", "K2c", "K3")     # uint8 rows; masks, core, threefry


def _dp_inputs(n, batch, nsteps, seed, device):
    per = [_epoch_inputs(batch, nsteps, seed + r, device) for r in range(n)]
    inp = {k: [p[k] for p in per] for k in ("uint8", "f32", "y", "masks",
                                             "threefry")}
    inp["params"] = [{name: {k: t.clone() for k, t in layer.items()}
                      for name, layer in per[0]["params"].items()}
                     for _ in range(n)]
    inp.update(core=per[0]["core"], batch=batch, n=n)
    return inp


def _dp(fn, form, inp, ring, **kw):
    pixels, rng = K2_FORMS[form]
    return fn(inp["params"], inp[pixels], inp["y"],
              None if rng == "masks" else inp[rng], 0.01, inp["batch"],
              masks=inp["masks"] if rng == "masks" else None,
              rng_impl="threefry" if rng == "threefry" else "core",
              axis_size=inp["n"], ring=ring, **kw)


@pytest.mark.parametrize("form", DP_FORMS)
@pytest.mark.parametrize("ring,n", RING_CASES)
def test_ring_kernel_keeps_lockstep_and_is_k1_plus_the_ring_tree(cuda, ring,
                                                                 n, form):
    # the rows design's ring, forced (the main path's forms run K6-ws)
    inp = _dp_inputs(n, 16, 3, seed=10 * n, device=cuda)
    key = f"epoch_step_dp_{ring}"
    before = epoch_step.launch_count[key]
    ps, ls = _dp(epoch_step.epoch_fused_sgd, form, inp, ring, _design="rows")
    ps2, ls2 = _dp(epoch_step.epoch_fused_sgd, form, inp, ring,
                   _design="rows")
    assert epoch_step.launch_count[key] == before + 2
    assert (epoch_step.last_launch["replicas"],
            epoch_step.last_launch["ring"],
            epoch_step.last_launch["design"]) == (n, ring, "rows")
    k1 = _dp(epoch_step.epoch_dp_sgd_reference, form, inp, ring,
             step_fn=fused_step.fused_loss_and_grads)
    ref = _dp(epoch_step.epoch_dp_sgd_reference, form, inp, ring)
    torch.cuda.synchronize()
    for r in range(n):
        got = _leaves(ps[r], ls[r])
        for a, b, c, d in zip(got, _leaves(ps[0], ls[r]),
                              _leaves(ps2[r], ls2[r]),
                              _leaves(k1[0][r], k1[1][r])):
            assert torch.equal(a, b)        # (a) lockstep
            assert torch.equal(a, c)        # (e) repeatable
            assert torch.equal(a, d)        # (b) K1 + ring tree + SGD
        plain = _leaves(ref[0][r], ref[1][r])
        torch.testing.assert_close(got[0], plain[0], rtol=1e-5, atol=1e-6)
        for a, p in zip(got[1:], plain[1:]):
            assert float((a - p).norm() / p.norm()) <= 1e-3


@pytest.mark.parametrize("form", DP_FORMS)
def test_one_replica_ring_launch_is_the_serial_kernel_bitwise(cuda, form):
    inp = _epoch_inputs(16, 3, seed=4, device=cuda)
    serial = _leaves(*_epoch(epoch_step.epoch_fused_sgd, form, inp))
    pixels, rng = K2_FORMS[form]
    ps, ls = epoch_step._ring_cuda(
        [inp["params"]], [inp[pixels]], [inp["y"]], [inp.get(rng)],
        [inp["masks"] if rng == "masks" else None], 0.01, 16, rng, 3, False,
        "allgather", 0)
    for a, b in zip(_leaves(ps[0], ls[0]), serial):
        assert torch.equal(a, b)


def test_in_kernel_philox_of_each_replica_is_the_plain_stream(cuda):
    seed = (1 << 31) + 5
    masks = []
    for replica in (0, 1, 3):
        km = epoch_step.kernel_mask_block(seed, 2, 64, rng_impl="core",
                                          device=cuda, replica=replica)
        pm = epoch_step.step_mask("core", seed, None, 2, 64, cuda,
                                  replica=replica)
        assert torch.equal(km, pm)
        masks.append(km)
    assert not torch.equal(masks[0], masks[1])


@pytest.mark.parametrize("design", ["ws", "rows", "mma"])
@pytest.mark.parametrize("ring", ["allgather", "reduce_scatter"])
def test_a_stalled_ring_raises_by_name_instead_of_hanging(cuda, ring, design):
    err = epoch_step.stalled_ring(cuda, n=2, ring=ring, design=design)
    assert isinstance(err, epoch_step.RingTimeoutError)
    assert "replica 1" in str(err) and "hop 0" in str(err), str(err)
    assert f"({design} design)" in str(err), str(err)


def test_dp_steps_on_a_card_mesh_track_each_other(cuda):
    split = synthetic_mnist(512, 3)
    x = torch.from_numpy(normalize_images(split.images)).to(cuda)
    y = torch.from_numpy(split.labels.astype(np.int32)).to(cuda)
    mesh = (cuda,) * 2
    runs = []
    for make in (make_dp_train_step, fused_step.make_pallas_dp_train_step):
        model = MLP(torch.Generator().manual_seed(0)).to(cuda)
        step, key = make(mesh, 0.01), threefry.key_data(1)
        k1 = _k1_key(x[:128], keyed=True)   # each replica's shard of 256 rows
        before = fused_step.launch_count[k1]
        losses = []
        for i in range(0, 512, 256):
            key, loss = step(model, key, x[i:i + 256], y[i:i + 256])
            losses.append(loss)
        runs.append((torch.stack(losses).cpu(),
                     fused_step.launch_count[k1] - before))
    (plain, plain_k1), (fused, fused_k1) = runs
    assert (plain_k1, fused_k1) == (0, 4)
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=0)


def test_bf16_dp_steps_on_a_card_mesh_run_k1_mma_and_track_the_cpu_mesh(cuda):
    # several replicas of one card share K1-mma's tensor-map cache and each
    # call's scratch: the card mesh's losses against the CPU mesh's (plain
    # versions, the same masks) at the JAX bf16 loss pin
    split = synthetic_mnist(512, 3)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        x = torch.from_numpy(normalize_images(split.images)).to(dev)
        y = torch.from_numpy(split.labels.astype(np.int32)).to(dev)
        model = MLP(torch.Generator().manual_seed(0)).to(dev)
        step = fused_step.make_pallas_dp_train_step((dev,) * 2, 0.01,
                                                    dtype="bfloat16")
        key = threefry.key_data(1)
        before = fused_step.launch_count["fused_mma_keyed"]
        losses = []
        for i in range(0, 512, 256):
            key, loss = step(model, key, x[i:i + 256], y[i:i + 256])
            losses.append(loss)
        runs.append((torch.stack(losses).cpu(),
                     fused_step.launch_count["fused_mma_keyed"] - before))
    (card, card_k1), (cpu, cpu_k1) = runs
    assert (card_k1, cpu_k1) == (4, 0)
    torch.testing.assert_close(card, cpu, rtol=1e-3, atol=0)


def test_parallel_cli_on_one_card_equals_the_serial_run(cuda, tmp_path,
                                                        capsys):
    if torch.cuda.device_count() != 1:
        pytest.skip("--parallel meshes every local card; K6's ring across "
                    "cards needs peer pointers")
    argv = ["--cached", "--kernel", "pallas_epoch", "--limit", "1024",
            "--checkpoint", "", "--path", str(tmp_path / "no_mnist")]
    _, serial = port_cli.train(argv)
    _, dp = port_cli.train(argv + ["--parallel"])
    assert "parallel=1x128" in capsys.readouterr().out
    for a, b in zip(serial, dp):
        np.testing.assert_array_equal(a, b)


# ---- slice 6: K2-ws, the weight-stationary design of K2's uint8 f32 forms ----

WS_FORMS = ("K2b", "K2c", "K3")     # uint8 rows; masks, core, threefry


@pytest.mark.parametrize("form", WS_FORMS)
@pytest.mark.parametrize("batch,nsteps", [(128, 24), (8, 5)])
def test_ws_kernel_is_bitwise_the_rows_design_and_k1(cuda, form, batch,
                                                     nsteps):
    inp = _epoch_inputs(batch, nsteps, seed=batch + nsteps + 2, device=cuda)
    before = dict(epoch_step.launch_count)
    got = _leaves(*_epoch(epoch_step.epoch_fused_sgd, form, inp))
    assert epoch_step.last_launch["design"] == "ws"
    assert epoch_step.launch_count["epoch_step_ws"] == \
        before["epoch_step_ws"] + 1
    again = _leaves(*_epoch(epoch_step.epoch_fused_sgd, form, inp))
    rows = _leaves(*_epoch(epoch_step._epoch_fused_sgd_rows, form, inp))
    assert epoch_step.last_launch["design"] == "rows"
    k1 = _leaves(*_k1_epoch(form, inp))
    torch.cuda.synchronize()
    for a, b, c, d in zip(got, again, rows, k1):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)


@pytest.mark.parametrize("form", WS_FORMS)
def test_ws_superstep_on_a_ragged_epoch_is_bitwise_k1(cuda, form):
    inp = _epoch_inputs(64, 11, seed=13, device=cuda)
    base = _leaves(*_epoch(epoch_step.epoch_fused_sgd, form, inp))
    for k in (2, 4, 8):
        got = _leaves(*_epoch(partial(epoch_step.epoch_fused_sgd,
                                      steps_per_iter=k), form, inp))
        ll = epoch_step.last_launch
        assert (ll["design"], ll["steps_per_iter"], ll["staged"]) == \
            ("ws", k, False)
        assert got[0].shape == (11,)
        for a, b in zip(got, base):
            assert torch.equal(a, b), (form, k)
    # and a ragged epoch passed with valid_steps, as the hot paths pad it
    pixels, rng = K2_FORMS[form]
    pad = 5 * 64
    padded = dict(inp)
    for name in (pixels, "y", "masks"):
        t = inp[name]
        padded[name] = torch.cat([t, t[:pad]])
    if rng == "threefry":
        padded["threefry"] = torch.cat([inp["threefry"], inp["threefry"][:5]])
    got = _leaves(*_epoch(partial(epoch_step.epoch_fused_sgd,
                                  steps_per_iter=8, valid_steps=11), form,
                          padded))
    for a, b in zip(got, base):
        assert torch.equal(a, b), form


def test_ws_table_is_bitwise_the_plain_normalise(cuda):
    got = epoch_step.kernel_pixel_table(cuda)
    want = device_normalize(torch.arange(256, dtype=torch.uint8, device=cuda))
    assert got.shape == (256, epoch_step.WS_TABLE_COPIES)
    for copy in got.unbind(1):
        assert torch.equal(copy, want)
    assert torch.equal(got.cpu(), epoch_step.kernel_pixel_table("cpu"))


def test_ws_refuses_a_block_cap_below_its_grid(cuda):
    inp = _epoch_inputs(8, 2, seed=1, device=cuda)
    with pytest.raises(ValueError, match="max_blocks"):
        _epoch(partial(epoch_step.epoch_fused_sgd, max_blocks=4), "K2c", inp)


def test_ws_stamps_build_keeps_the_bits_and_splits_the_step(cuda):
    inp = _epoch_inputs(128, 6, seed=4, device=cuda)
    base = _leaves(*_epoch(epoch_step.epoch_fused_sgd, "K2c", inp))
    before = dict(epoch_step.launch_count)
    params, losses, split, per_step, mhz = epoch_step.ws_phase_stamps(
        inp["params"], inp["uint8"], inp["y"], inp["core"], 0.01, 128)
    assert 100 < mhz < 5000
    assert dict(epoch_step.launch_count) == before
    for a, b in zip(_leaves(params, losses), base):
        assert torch.equal(a, b)
    assert list(split) == list(epoch_step.WS_PHASES)
    assert all(v >= 0 for v in split.values()) and per_step > 0
    assert abs(sum(split.values()) - per_step) <= 1e-6 * per_step + 1e-9


# ---- slice 7: K1-split, the split design of K1's f32 forms ----

@pytest.mark.parametrize("rng", [False, True], ids=["mask", "rng"])
@pytest.mark.parametrize("batch", [128, 96, 8, 3])
def test_split_design_is_bitwise_the_rows_design(cuda, batch, rng):
    params, x, y, mask = _inputs(batch, batch + 11, cuda)
    seed = (1 << 31) + 3 * batch

    def call(design=None):
        if rng:
            return fused_step.fused_loss_and_grads_rng(params, x, y, seed,
                                                       _design=design)
        return fused_step.fused_loss_and_grads(params, x, y, mask,
                                               _design=design)
    key = "fused_split_rng" if rng else "fused_split"
    before = fused_step.launch_count[key]
    got = call()
    assert fused_step.last_launch == {"design": "split", "form": key}
    again = call()
    assert fused_step.launch_count[key] == before + 2
    rows = call("rows")
    assert fused_step.last_launch["design"] == "rows"
    ref = fused_step.fused_loss_and_grads_reference(
        params, x, y, philox.rng_mask(seed, batch, cuda) if rng else mask)
    torch.cuda.synchronize()
    for a, b, c in zip(_k1_leaves(*got), _k1_leaves(*again),
                       _k1_leaves(*rows)):
        assert torch.equal(a, b) and torch.equal(a, c)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=0)
    for n in ref[1]:
        for k in ref[1][n]:
            torch.testing.assert_close(got[1][n][k], ref[1][n][k], rtol=2e-4,
                                       atol=1e-6, msg=f"{n}.{k}")


def test_split_design_takes_odd_offsets_and_replays_in_a_graph(cuda):
    params, x, y, mask = _inputs(128, 5, cuda)
    base = _k1_leaves(*fused_step.fused_loss_and_grads(params, x, y, mask))
    flat = torch.empty(x.numel() + 1, device=cuda)
    view = flat[1:].view_as(x)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0
    odd = fused_step.fused_loss_and_grads(params, view, y, mask)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused_step.fused_loss_and_grads(params, x, y, mask)
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip(base, _k1_leaves(*odd), _k1_leaves(*captured)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_split_design_keeps_its_tensor_maps_across_many_inputs(cuda):
    # more distinct x and scratch addresses than the wrapper's cache of
    # tensor maps has slots: every call bitwise the rows design
    params, x, y, mask = _inputs(96, 9, cuda)
    xs = [x + 0.0 for _ in range(48)]
    for xi in xs:
        got = fused_step.fused_loss_and_grads(params, xi, y, mask)
        want = fused_step.fused_loss_and_grads(params, xi, y, mask,
                                               _design="rows")
        for a, b in zip(_k1_leaves(*got), _k1_leaves(*want)):
            assert torch.equal(a, b)


def test_split_stamps_build_keeps_the_bits_and_splits_the_call(cuda):
    params, x, y, mask = _inputs(128, 6, cuda)
    base = _k1_leaves(*fused_step.fused_loss_and_grads(params, x, y, mask))
    before = dict(fused_step.launch_count)
    loss, grads, split, per_call = fused_step.split_phase_stamps(
        params, x, y, mask, calls=4)
    assert dict(fused_step.launch_count) == before
    for a, b in zip(_k1_leaves(loss, grads), base):
        assert torch.equal(a, b)
    assert list(split) == list(fused_step.SPLIT_PHASES)
    assert all(v >= 0 for v in split.values()) and per_call > 0
    assert abs(sum(split.values()) - per_call) <= 1e-6 * per_call + 1e-9


def test_split_and_rows_designs_train_the_same_cached_epoch(cuda, tmp_path,
                                                            monkeypatch):
    argv = ["--cached", "--limit", "1024", "--checkpoint", "",
            "--path", str(tmp_path / "no_mnist")]
    before = dict(fused_step.launch_count)
    _, split = port_cli.train(argv)
    assert fused_step.launch_count["fused_split_keyed"] == \
        before["fused_split_keyed"] + 1024 // 128
    monkeypatch.setattr(fused_step, "fused_design", lambda *a: "rows")
    _, rows = port_cli.train(argv)
    # the rows design's keyed step: the mask entry reads the key, then K1
    for key in ("fused_step", "threefry_mask"):
        assert fused_step.launch_count[key] == before[key] + 1024 // 128
    for a, b in zip(split, rows):
        np.testing.assert_array_equal(a, b)


# ---- the keyed forms: jax's threefry mask drawn in K1-split and K1-mma ----

# keys whose words span the int32 bitcast, and a split chain's
KEYED_KEYS = [(0x80000000, 0x7FFFFFFF), (0xFFFFFFFF, 0x80000001),
              (0xDEADBEEF, 12345)] + threefry.step_keys((0, 9), 5)[1]


def _equal(got, want):
    assert torch.equal(got[0], want[0])
    for n in want[1]:
        for k in want[1][n]:
            assert torch.equal(got[1][n][k], want[1][n][k]), f"{n}.{k}"


@pytest.mark.parametrize("bf16", [False, True], ids=["split", "mma"])
@pytest.mark.parametrize("batch", [128, 96, 3])
def test_keyed_form_is_its_mask_input_form_bitwise(cuda, batch, bf16):
    params, x, y, _ = _inputs(batch, batch + 40, cuda)
    if bf16:
        x = x.to(torch.bfloat16)
    table = threefry.to_int32_words(KEYED_KEYS).to(cuda)
    key = _k1_key(x, keyed=True)
    for i, k in enumerate(KEYED_KEYS):
        before = dict(fused_step.launch_count)
        got = fused_step.fused_loss_and_grads_keyed(params, x, y, table[i])
        assert fused_step.launch_count[key] == before[key] + 1
        assert fused_step.launch_count["threefry_mask"] == \
            before["threefry_mask"]
        mask = fused_step.dropout_mask(k, batch, cuda)
        _equal(got, fused_step.fused_loss_and_grads(params, x, y, mask))


@pytest.mark.parametrize("dtype,key", [(torch.float32, "fused_step"),
                                       (torch.bfloat16, "fused_step_bf16")])
def test_keyed_step_past_128_rows_keeps_the_mask_entry(cuda, dtype, key):
    params, x, y, _ = _inputs(256, 5, cuda)
    x = x.to(dtype)
    words = threefry.to_int32_words([KEYED_KEYS[0]]).to(cuda)[0]
    before = dict(fused_step.launch_count)
    got = fused_step.fused_loss_and_grads_keyed(params, x, y, words)
    for k in (key, "threefry_mask"):
        assert fused_step.launch_count[k] == before[k] + 1
    assert fused_step.last_launch["design"] == "rows"
    mask = fused_step.dropout_mask(KEYED_KEYS[0], 256, cuda)
    _equal(got, fused_step.fused_loss_and_grads(params, x, y, mask))


def test_keyed_mask_entry_reads_the_key_from_the_card(cuda):
    table = threefry.to_int32_words(KEYED_KEYS).to(cuda)
    for i, k in enumerate(KEYED_KEYS):
        for batch in (128, 3):
            got = fused_step.keyed_dropout_mask(table[i], batch, cuda)
            assert torch.equal(got, fused_step.dropout_mask(k, batch, cuda))


@pytest.mark.parametrize("bf16", [False, True], ids=["split", "mma"])
def test_keyed_call_in_a_graph_reads_the_key_at_replay(cuda, bf16):
    # the key is device memory, not a launch argument: a captured call
    # draws the mask of whatever key the table holds when it replays
    params, x, y, _ = _inputs(128, 2, cuda)
    if bf16:
        x = x.to(torch.bfloat16)
    words = threefry.to_int32_words([KEYED_KEYS[0]]).to(cuda)[0]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused_step.fused_loss_and_grads_keyed(params, x, y, words)
    for k in KEYED_KEYS[:3]:
        words.copy_(threefry.to_int32_words([k])[0])
        graph.replay()
        torch.cuda.synchronize()
        mask = fused_step.dropout_mask(k, 128, cuda)
        _equal(captured, fused_step.fused_loss_and_grads(params, x, y, mask))


@pytest.mark.parametrize("bf16", [False, True], ids=["split", "mma"])
def test_keyed_stamps_build_is_its_default_build(cuda, bf16):
    params, x, y, _ = _inputs(128, 3, cuda)
    if bf16:
        x = x.to(torch.bfloat16)
    words = threefry.to_int32_words([KEYED_KEYS[1]]).to(cuda)[0]
    base = fused_step.fused_loss_and_grads_keyed(params, x, y, words)
    stamps = (fused_step.mma_phase_stamps if bf16
              else fused_step.split_phase_stamps)
    before = dict(fused_step.launch_count)
    loss, grads, split, per_call = stamps(params, x, y, key_words=words,
                                          calls=4)
    assert dict(fused_step.launch_count) == before
    _equal((loss, grads), base)
    assert per_call > 0 and all(v >= 0 for v in split.values())


def test_keyed_entries_refuse_a_null_or_misaligned_key(cuda):
    params, x, y, _ = _inputs(8, 1, cuda)
    odd = torch.zeros(5, dtype=torch.int32, device=cuda)[1:3]
    with pytest.raises(ValueError, match="8 bytes"):
        fused_step.fused_loss_and_grads_keyed(params, x, y, odd)
    for design, xin in (("split", x), ("mma", x.to(torch.bfloat16))):
        lib = fused_step._staged_lib(design)
        p = xin.data_ptr()
        for key in (None, odd.data_ptr()):
            err = getattr(lib, f"pdmt_{design}_step")(
                p, y.data_ptr(), 2, None, key, 0, 1, *([p] * 12), None, 8,
                1.0 / 8, fused_step._stream(cuda))
            assert err != 0, (design, key)
    lib = fused_step._kernel_lib()
    out = torch.empty((8, 128), device=cuda)
    for key in (None, odd.data_ptr()):
        assert lib.pdmt_threefry_mask_keyed(key, 8, out.data_ptr(),
                                            fused_step._stream(cuda)) != 0


def test_cached_pallas_epoch_draws_no_mask_outside_the_kernel(cuda):
    split = synthetic_mnist(1024, seed=0)
    x_all = torch.from_numpy(scan.resident_images(split.images)).to(cuda)
    y_all = torch.from_numpy(split.labels.astype(np.int32)).to(cuda)
    idx = np.arange(1024, dtype=np.int32).reshape(8, 128)
    params = MLP.from_seed(0).to(cuda).params()
    runs = []
    for dtype in ("float32", "bfloat16"):
        before = dict(fused_step.launch_count)
        _, key, losses = scan.make_epoch_fn(0.01, kernel="pallas",
                                            dtype=dtype)(params, (0, 1),
                                                         x_all, y_all, idx)
        got = {k: v - before[k] for k, v in fused_step.launch_count.items()
               if v != before[k]}
        assert got == {f"fused_{'mma' if dtype == 'bfloat16' else 'split'}"
                       f"_keyed": 8}
        assert key == threefry.step_key_table((0, 1), 8)[0]
        runs.append(losses)
    assert all(torch.isfinite(ls).all() for ls in runs)


# ---- K1-mma, the mma design of K1's bf16 forms ----

def _mma_call(params, x, y, mask, seed, rng, design=None):
    if rng:
        return fused_step.fused_loss_and_grads_rng(params, x, y, seed,
                                                   _design=design)
    return fused_step.fused_loss_and_grads(params, x, y, mask, _design=design)


@pytest.mark.parametrize("rng", [False, True], ids=["mask", "rng"])
@pytest.mark.parametrize("batch", [128, 96, 8, 3])
def test_mma_design_holds_the_bf16_pins_and_repeats_bitwise(cuda, batch, rng):
    params, x, y, mask = _inputs(batch, batch + 23, cuda)
    xb = x.to(torch.bfloat16)
    seed = (1 << 31) + 7 * batch
    key = "fused_mma_rng" if rng else "fused_mma"
    before = dict(fused_step.launch_count)
    got = _mma_call(params, xb, y, mask, seed, rng)
    assert fused_step.last_launch == {"design": "mma", "form": key}
    again = _mma_call(params, xb, y, mask, seed, rng)
    assert fused_step.launch_count[key] == before[key] + 2
    rows = _mma_call(params, xb, y, mask, seed, rng, design="rows")
    assert fused_step.last_launch["design"] == "rows"
    pm = philox.rng_mask(seed, batch, cuda)
    ref = fused_step.step_reference_bf16(params, xb, y, pm if rng else mask)
    torch.cuda.synchronize()
    for a, b in zip(_k1_leaves(*got), _k1_leaves(*again)):
        assert torch.equal(a, b)
    _bf16_close(got, ref)
    _bf16_close(got, rows)
    if rng:
        on_mask = fused_step.fused_loss_and_grads(params, xb, y, pm)
        for a, b in zip(_k1_leaves(*got), _k1_leaves(*on_mask)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("rng", [False, True], ids=["mask", "rng"])
def test_mma_design_takes_odd_offsets_and_replays_in_a_graph(cuda, rng):
    params, x, y, mask = _inputs(128, 15, cuda)
    xb = x.to(torch.bfloat16)
    base = _k1_leaves(*_mma_call(params, xb, y, mask, 99, rng))
    flat = torch.empty(xb.numel() + 1, dtype=xb.dtype, device=cuda)
    view = flat[1:].view_as(xb)
    view.copy_(xb)
    assert view.data_ptr() % 16 != 0
    odd = _mma_call(params, view, y, mask, 99, rng)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _mma_call(params, xb, y, mask, 99, rng)
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip(base, _k1_leaves(*odd), _k1_leaves(*captured)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_mma_design_keeps_its_tensor_maps_across_many_inputs(cuda):
    # more distinct x and scratch addresses than the wrapper's cache of
    # tensor maps has slots: every call within the pins of the rows design
    params, x, y, mask = _inputs(96, 19, cuda)
    for _ in range(48):
        xi = (x + 0.0).to(torch.bfloat16)
        got = fused_step.fused_loss_and_grads(params, xi, y, mask)
        assert fused_step.last_launch["design"] == "mma"
        _bf16_close(got, fused_step.fused_loss_and_grads(params, xi, y, mask,
                                                         _design="rows"))


def test_mma_stamps_build_keeps_the_bits_and_splits_the_call(cuda):
    params, x, y, mask = _inputs(128, 6, cuda)
    xb = x.to(torch.bfloat16)
    base = _k1_leaves(*fused_step.fused_loss_and_grads(params, xb, y, mask))
    before = dict(fused_step.launch_count)
    loss, grads, split, per_call = fused_step.mma_phase_stamps(
        params, xb, y, mask, calls=4)
    assert dict(fused_step.launch_count) == before
    for a, b in zip(_k1_leaves(loss, grads), base):
        assert torch.equal(a, b)
    assert list(split) == list(fused_step.MMA_PHASES)
    assert all(v >= 0 for v in split.values()) and per_call > 0
    assert abs(sum(split.values()) - per_call) <= 1e-6 * per_call + 1e-9


def test_mma_and_rows_designs_train_close_cached_bf16_epochs(cuda, tmp_path,
                                                             monkeypatch):
    # the tensor cores sum in another order than the rows design, so a
    # bf16 rounding may go the other way: per-step losses at the bf16
    # runs' tolerance (rtol 1e-2, chip_smoke.py BF16_TRAIN_RTOL)
    argv = ["--cached", "--kernel", "pallas_rng", "--dtype", "bfloat16",
            "--limit", "1024", "--checkpoint", "",
            "--path", str(tmp_path / "no_mnist")]
    # the captured step reads its seed from the key table: the device-seed
    # forms
    before = dict(fused_step.launch_count)
    _, mma = port_cli.train(argv)
    assert fused_step.launch_count["fused_mma_rng_dev"] == \
        before["fused_mma_rng_dev"] + 1024 // 128
    monkeypatch.setattr(fused_step, "fused_design", lambda *a: "rows")
    _, rows = port_cli.train(argv)
    assert fused_step.launch_count["fused_step_rng_dev_bf16"] == \
        before["fused_step_rng_dev_bf16"] + 1024 // 128
    for a, b in zip(mma, rows):
        np.testing.assert_allclose(a, b, rtol=1e-2)


# ---- K2-mma, the tensor-core design of K2's uint8 bf16 forms ----
#
# K2-mma runs K1-mma's phase code, so it is held bitwise against K1-mma +
# SGD per step; against its plain version and the rows design (whose sums
# run in another order) at the bf16 epoch pins: losses rtol 1e-3 / atol
# 1e-4, params 2e-3 in relative Frobenius norm.

MMA_FORMS = ("K2b", "K2c", "K3")    # uint8 rows; masks, core, threefry


def _bf16_epoch_close(got, ref):
    torch.testing.assert_close(got[0], ref[0], rtol=1e-3, atol=1e-4)
    for a, r in zip(got[1:], ref[1:]):
        assert float((a - r).norm() / r.norm()) <= 2e-3


@pytest.mark.parametrize("form", MMA_FORMS)
@pytest.mark.parametrize("batch,nsteps", [(128, 12), (96, 6), (8, 5)])
def test_mma_epoch_is_bitwise_k1_mma_plus_sgd_and_within_the_pins(
        cuda, form, batch, nsteps):
    inp = _epoch_inputs(batch, nsteps, seed=batch + nsteps + 7, device=cuda)
    kernel = partial(epoch_step.epoch_fused_sgd, compute_bf16=True)
    before = dict(epoch_step.launch_count)
    got = _leaves(*_epoch(kernel, form, inp))
    ll = dict(epoch_step.last_launch)
    assert (ll["design"], ll["form"], ll["bf16"], ll["blocks"]) == (
        "mma", "/".join(K2_FORMS[form]), True,
        epoch_step.mma_epoch_blocks(batch))
    again = _leaves(*_epoch(kernel, form, inp))
    assert epoch_step.launch_count["epoch_step_mma"] == \
        before["epoch_step_mma"] + 2
    k1 = _leaves(*_k1_epoch_bf16(form, inp))
    rows = _leaves(*_epoch(partial(epoch_step._epoch_fused_sgd_rows,
                                   compute_bf16=True), form, inp))
    assert epoch_step.last_launch["design"] == "rows"
    k1_rows = _leaves(*_k1_epoch_bf16(form, inp, "rows"))
    ref = _leaves(*_epoch(partial(epoch_step.epoch_fused_sgd_reference,
                                  compute_bf16=True), form, inp))
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, k1):
        assert torch.equal(a, b) and torch.equal(a, c)
    for a, c in zip(rows, k1_rows):
        assert torch.equal(a, c)
    _bf16_epoch_close(got, ref)
    _bf16_epoch_close(got, rows)


@pytest.mark.parametrize("form", MMA_FORMS)
def test_mma_epoch_superstep_on_a_ragged_epoch_is_bitwise_k1(cuda, form):
    inp = _epoch_inputs(64, 11, seed=17, device=cuda)
    fn = partial(epoch_step.epoch_fused_sgd, compute_bf16=True)
    base = _leaves(*_epoch(fn, form, inp))
    pixels, rng = K2_FORMS[form]
    padded = dict(inp)
    for name in (pixels, "y", "masks"):
        padded[name] = torch.cat([inp[name], inp[name][:5 * 64]])
    if rng == "threefry":
        padded["threefry"] = torch.cat([inp["threefry"], inp["threefry"][:5]])
    for k in (2, 4, 8):
        for data, valid in ((inp, None), (padded, 11)):
            got = _leaves(*_epoch(partial(fn, steps_per_iter=k,
                                          valid_steps=valid), form, data))
            ll = epoch_step.last_launch
            assert (ll["design"], ll["steps_per_iter"], ll["staged"]) == \
                ("mma", k, False)
            for a, b in zip(got, base):
                assert torch.equal(a, b), (form, k, valid)


def test_mma_epoch_refuses_a_block_cap_below_its_grid(cuda):
    inp = _epoch_inputs(8, 2, seed=1, device=cuda)
    with pytest.raises(ValueError, match="max_blocks"):
        _epoch(partial(epoch_step.epoch_fused_sgd, compute_bf16=True,
                       max_blocks=8), "K2c", inp)


def test_mma_epoch_table_is_k1_mma_rows_bitwise(cuda):
    table = epoch_step.pixel_table_bf16(cuda)
    px = torch.arange(256, dtype=torch.uint8, device=cuda)
    assert table.dtype == torch.bfloat16
    assert torch.equal(table, device_normalize(px).to(torch.bfloat16))
    assert torch.equal(table.cpu(), epoch_step.pixel_table_bf16("cpu"))


def test_mma_epoch_stamps_build_keeps_the_bits_and_splits_the_step(cuda):
    inp = _epoch_inputs(128, 6, seed=4, device=cuda)
    kernel = partial(epoch_step.epoch_fused_sgd, compute_bf16=True)
    base = _leaves(*_epoch(kernel, "K2c", inp))
    before = dict(epoch_step.launch_count)
    params, losses, split, per_step = epoch_step.mma_epoch_phase_stamps(
        inp["params"], inp["uint8"], inp["y"], inp["core"], 0.01, 128)
    assert dict(epoch_step.launch_count) == before
    for a, b in zip(_leaves(params, losses), base):
        assert torch.equal(a, b)
    assert list(split) == list(epoch_step.MMA_EPOCH_PHASES)
    assert all(v >= 0 for v in split.values()) and per_step > 0
    assert abs(sum(split.values()) - per_step) <= 1e-6 * per_step + 1e-9


def test_cached_bf16_cli_runs_one_mma_epoch_launch_per_epoch(cuda, tmp_path,
                                                          capsys):
    before = dict(epoch_step.launch_count)
    rc = port_cli.main(["--cached", "--kernel", "pallas_epoch", "--dtype",
                        "bfloat16", "--n_epochs", "2", "--limit", "1024",
                        "--checkpoint", "", "--path",
                        str(tmp_path / "no_mnist")])
    out = capsys.readouterr().out
    assert rc == 0 and "dtype=bfloat16" in out
    assert re.search(r"^Epoch=1, train_loss=\S+, val_loss=\S+", out, re.M)
    assert epoch_step.launch_count["epoch_step_mma"] == \
        before["epoch_step_mma"] + 2
    assert epoch_step.last_launch["design"] == "mma"


# ---- K6-ws, the DP rings on K2-ws's column-owner step ----

RING_WS_CASES = RING_CASES + [("allgather", 3), ("reduce_scatter", 2)]


@pytest.mark.parametrize("form", DP_FORMS)
@pytest.mark.parametrize("batch,nsteps", [(128, 4), (96, 3), (8, 3)])
@pytest.mark.parametrize("ring,n", RING_WS_CASES)
def test_ring_ws_is_bitwise_the_rows_ring_and_k1_plus_the_tree(
        cuda, ring, n, batch, nsteps, form):
    inp = _dp_inputs(n, batch, nsteps, seed=10 * n + batch, device=cuda)
    key = f"epoch_step_dp_ws_{ring}"
    before = dict(epoch_step.launch_count)
    ps, ls = _dp(epoch_step.epoch_fused_sgd, form, inp, ring)
    ll = dict(epoch_step.last_launch)
    cols = epoch_step.ring_ws_cols(n)
    assert (ll["design"], ll["replicas"], ll["ring"], ll["cols"],
            ll["blocks"]) == ("ws", n, ring, cols, 128 // cols)
    ps2, ls2 = _dp(epoch_step.epoch_fused_sgd, form, inp, ring)
    assert epoch_step.launch_count[key] == before[key] + 2
    assert epoch_step.launch_count[f"epoch_step_dp_{ring}"] == \
        before[f"epoch_step_dp_{ring}"]
    rows = _dp(epoch_step.epoch_fused_sgd, form, inp, ring, _design="rows")
    k1 = _dp(epoch_step.epoch_dp_sgd_reference, form, inp, ring,
             step_fn=fused_step.fused_loss_and_grads)
    torch.cuda.synchronize()
    for r in range(n):
        got = _leaves(ps[r], ls[r])
        for a, b, c, d, e in zip(got, _leaves(ps[0], ls[r]),
                                 _leaves(ps2[r], ls2[r]),
                                 _leaves(rows[0][r], rows[1][r]),
                                 _leaves(k1[0][r], k1[1][r])):
            assert torch.equal(a, b)        # lockstep
            assert torch.equal(a, c)        # repeatable
            assert torch.equal(a, d)        # the rows design's ring
            assert torch.equal(a, e)        # K1 + ring tree + SGD


@pytest.mark.parametrize("form", DP_FORMS)
def test_one_replica_ring_ws_launch_is_k2_ws_bitwise(cuda, form):
    inp = _epoch_inputs(128, 3, seed=5, device=cuda)
    serial = _leaves(*_epoch(epoch_step.epoch_fused_sgd, form, inp))
    assert epoch_step.last_launch["design"] == "ws"
    pixels, rng = K2_FORMS[form]
    ps, ls = epoch_step._ring_cuda(
        [inp["params"]], [inp[pixels]], [inp["y"]], [inp.get(rng)],
        [inp["masks"] if rng == "masks" else None], 0.01, 128, rng, 3, False,
        "allgather", 0, design="ws")
    assert epoch_step.last_launch["design"] == "ws"
    for a, b in zip(_leaves(ps[0], ls[0]), serial):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", DP_FORMS)
def test_k2_ws_at_four_columns_a_block_is_bitwise_two(cuda, form):
    # the step K6-ws runs at n = 3, 4 (32 blocks), alone: K2-ws's bits
    inp = _epoch_inputs(128, 4, seed=6, device=cuda)
    base = _leaves(*_epoch(epoch_step.epoch_fused_sgd, form, inp))
    pixels, rng = K2_FORMS[form]
    got = epoch_step._ws_cuda(
        inp["params"], inp[pixels], inp["y"], inp.get(rng), 0.01, 128,
        inp["masks"] if rng == "masks" else None, rng, 4, 1, 4, 0, cols=4)
    assert (epoch_step.last_launch["blocks"],
            epoch_step.last_launch["cols"]) == (32, 4)
    for a, b in zip(_leaves(*got[:2]), base):
        assert torch.equal(a, b)


def test_ring_ws_library_shares_the_wrappers_constants_and_fits(cuda):
    lib = epoch_step._ring_ws_lib()      # checks its constants on load
    ws = epoch_step._ws_lib()
    for cols in (2, 4, 8):
        assert ws.pdmt_ws_smem_bytes_at(cols) == \
            epoch_step.ws_smem_bytes(cols)
    for n in range(1, epoch_step.RING_WS_MAX_REPLICAS + 1):
        blocks = ctypes.c_int(0)
        for rng in range(3):
            assert lib.pdmt_ring_ws_coresident(n, rng,
                                               ctypes.byref(blocks)) == 0
            assert blocks.value >= n * 128 // epoch_step.ring_ws_cols(n)


def test_ring_ws_stamps_build_keeps_the_bits_and_splits_the_step(cuda):
    for ring, n in (("allgather", 4), ("reduce_scatter", 3)):
        inp = _dp_inputs(n, 128, 3, seed=2, device=cuda)
        base = _dp(epoch_step.epoch_fused_sgd, "K2c", inp, ring)
        before = dict(epoch_step.launch_count)
        ps, ls, split, per_step = _dp(epoch_step.k6_phase_stamps, "K2c", inp,
                                      ring)
        assert dict(epoch_step.launch_count) == before
        for r in range(n):
            for a, b in zip(_leaves(ps[r], ls[r]),
                            _leaves(base[0][r], base[1][r])):
                assert torch.equal(a, b)
        assert list(split) == epoch_step.k6_phases(ring, n)
        assert all(v >= 0 for v in split.values()) and per_step > 0
        assert abs(sum(split.values()) - per_step) <= 1e-6 * per_step + 1e-9


# ---- K6-mma, the DP rings' bf16 forms on K2-mma's tensor-core step ----
# Bitwise against K1-mma per replica + the ring's tree + SGD (the same
# phase code and trees); against its plain version and the rows design's
# ring in bf16 (whose sums run in other orders) at the bf16 epoch pins.

RING_MMA_CASES = [(ring, n) for ring in ("allgather", "reduce_scatter")
                  for n in (2, 3, 4)]


def _step_mma(params, x, y, mask):
    return fused_step.fused_loss_and_grads(params, x.to(torch.bfloat16), y,
                                           mask)


@pytest.mark.parametrize("form", DP_FORMS)
@pytest.mark.parametrize("batch,nsteps", [(128, 4), (96, 3), (8, 3)])
@pytest.mark.parametrize("ring,n", RING_MMA_CASES)
def test_ring_mma_is_bitwise_k1_mma_plus_the_tree_and_within_the_pins(
        cuda, ring, n, batch, nsteps, form):
    inp = _dp_inputs(n, batch, nsteps, seed=20 * n + batch, device=cuda)
    kernel = partial(epoch_step.epoch_fused_sgd, compute_bf16=True)
    key = f"epoch_step_dp_mma_{ring}"
    before = dict(epoch_step.launch_count)
    ps, ls = _dp(kernel, form, inp, ring)
    ll = dict(epoch_step.last_launch)
    assert (ll["design"], ll["replicas"], ll["ring"], ll["bf16"],
            ll["blocks"]) == ("mma", n, ring, True,
                              epoch_step.RING_MMA_BLOCKS)
    ps2, ls2 = _dp(kernel, form, inp, ring)
    assert epoch_step.launch_count[key] == before[key] + 2
    rows = _dp(kernel, form, inp, ring, _design="rows")
    assert epoch_step.launch_count[f"epoch_step_dp_{ring}_bf16"] == \
        before[f"epoch_step_dp_{ring}_bf16"] + 1
    k1 = _dp(epoch_step.epoch_dp_sgd_reference, form, inp, ring,
             step_fn=_step_mma)
    ref = _dp(epoch_step.epoch_dp_sgd_reference, form, inp, ring,
              compute_bf16=True)
    torch.cuda.synchronize()
    for r in range(n):
        got = _leaves(ps[r], ls[r])
        for a, b, c, e in zip(got, _leaves(ps[0], ls[r]),
                              _leaves(ps2[r], ls2[r]),
                              _leaves(k1[0][r], k1[1][r])):
            assert torch.equal(a, b)        # lockstep
            assert torch.equal(a, c)        # repeatable
            assert torch.equal(a, e)        # K1-mma + ring tree + SGD
        _bf16_epoch_close(got, _leaves(ref[0][r], ref[1][r]))
        _bf16_epoch_close(got, _leaves(rows[0][r], rows[1][r]))


@pytest.mark.parametrize("form", DP_FORMS)
def test_one_replica_ring_mma_launch_is_k2_mma_bitwise(cuda, form):
    inp = _epoch_inputs(128, 3, seed=8, device=cuda)
    serial = _leaves(*_epoch(partial(epoch_step.epoch_fused_sgd,
                                     compute_bf16=True), form, inp))
    assert epoch_step.last_launch["design"] == "mma"
    pixels, rng = K2_FORMS[form]
    ps, ls = epoch_step._ring_cuda(
        [inp["params"]], [inp[pixels]], [inp["y"]], [inp.get(rng)],
        [inp["masks"] if rng == "masks" else None], 0.01, 128, rng, 3, True,
        "allgather", 0, design="mma")
    assert epoch_step.last_launch["design"] == "mma"
    for a, b in zip(_leaves(ps[0], ls[0]), serial):
        assert torch.equal(a, b)


def test_ring_mma_library_shares_the_wrappers_constants_and_fits(cuda):
    lib = epoch_step._ring_mma_lib()      # checks its constants on load
    blocks = ctypes.c_int(0)
    for rng in range(3):
        assert lib.pdmt_ring_mma_coresident(rng, ctypes.byref(blocks)) == 0
        assert blocks.value >= (epoch_step.RING_MMA_MAX_REPLICAS
                                * epoch_step.RING_MMA_BLOCKS)
    assert lib.pdmt_ring_mma_scratch_bytes(128) == \
        epoch_step._mma_lib().pdmt_emma_scratch_bytes(128)


def test_ring_mma_stamps_build_keeps_the_bits_and_splits_the_step(cuda):
    kernel = partial(epoch_step.epoch_fused_sgd, compute_bf16=True)
    for ring, n in (("allgather", 4), ("reduce_scatter", 3)):
        inp = _dp_inputs(n, 128, 3, seed=2, device=cuda)
        base = _dp(kernel, "K2c", inp, ring)
        before = dict(epoch_step.launch_count)
        ps, ls, split, per_step = _dp(epoch_step.k6_mma_phase_stamps, "K2c",
                                      inp, ring)
        assert dict(epoch_step.launch_count) == before
        for r in range(n):
            for a, b in zip(_leaves(ps[r], ls[r]),
                            _leaves(base[0][r], base[1][r])):
                assert torch.equal(a, b)
        assert list(split) == epoch_step.k6_mma_phases(ring, n)
        assert all(v >= 0 for v in split.values()) and per_step > 0
        assert abs(sum(split.values()) - per_step) <= 1e-6 * per_step + 1e-9


@pytest.mark.parametrize("ring,impl", [("allgather", "threefry2x32"),
                                       ("reduce_scatter", "rbg")])
def test_bf16_dp_scan_on_a_card_mesh_runs_ring_mma_and_tracks_the_cpu_mesh(
        cuda, ring, impl):
    # the DP scan (what --parallel --cached calls) in bf16: one K6-mma
    # launch an epoch; its losses against the CPU mesh's (plain versions,
    # the same masks) at the bf16 epoch pins
    n, B, S = 2, 128, 6
    split = synthetic_mnist(n * B * S, seed=4)
    idxs = np.random.default_rng(4).permutation(n * B * S).astype(
        np.int32).reshape(1, S, n * B)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        x = torch.from_numpy(split.images.reshape(n * B * S, -1)).to(dev)
        y = torch.from_numpy(split.labels.astype(np.int32)).to(dev)
        run = scan.make_dp_run_fn((dev,) * n, 0.01, dtype="bfloat16",
                                  kernel="pallas_epoch", ring=ring, impl=impl)
        before = epoch_step.launch_count[f"epoch_step_dp_mma_{ring}"]
        _, _, losses = run(MLP.from_seed(0).params(), threefry.key_data(1),
                           x, y, idxs)
        runs.append((losses.cpu(), epoch_step.launch_count[
            f"epoch_step_dp_mma_{ring}"] - before))
    (card, card_k6), (cpu, cpu_k6) = runs
    assert (card_k6, cpu_k6) == (1, 0)
    assert epoch_step.last_launch["design"] == "mma"
    torch.testing.assert_close(card, cpu, rtol=1e-3, atol=1e-4)


# ---- the process-level world: 2 ranks on the card (gloo where they share
# it), each a process of this file run as a script ----

WORLD_STEPS = 10


def _world_rank(out, dtype):
    """A rank: WORLD_STEPS steps of make_pallas_dp_train_step on a
    WorldMesh at 128 rows a rank; saves losses, params and launches."""
    from pytorch_ddp_mnist_tpu_torch.ops.fused_step import (
        make_pallas_dp_train_step)
    from pytorch_ddp_mnist_tpu_torch.parallel.mesh import WorldMesh
    from pytorch_ddp_mnist_tpu_torch.parallel.wireup import initialize_runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    rt = initialize_runtime("env", device_type="cuda")
    mesh = WorldMesh([rt.device], world_size=rt.size, rank=rt.rank)
    rows = _world_rows(rt.size)[rt.rank]
    losses, params = _world_steps(make_pallas_dp_train_step(
        mesh, 0.01, dtype=dtype), rt.device,
        lambda s: rows[s * 128:(s + 1) * 128])
    torch.save({"losses": losses, "params": params,
                "launches": dict(fused_step.launch_count),
                "backend": rt.backend},
               f"{out}/rank{rt.rank}.pt")
    rt.finalize()


def _world_rows(n):
    from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
    out = []
    for r in range(n):
        s = ShardedSampler(4096, num_replicas=n, rank=r, seed=42)
        out.append(s.indices())
    return out


def _world_steps(step, device, rows_of_step):
    split = synthetic_mnist(4096, seed=0)
    x_all = normalize_images(split.images)
    y_all = split.labels.astype(np.int32)
    model = MLP.from_seed(0).to(device)
    # the steps' key table, as `fit` builds an epoch's
    _, table = step.key_table(threefry.key_data(1), WORLD_STEPS, device)
    losses = []
    for s in range(WORLD_STEPS):
        r = rows_of_step(s)
        losses.append(step.run(model, table[s],
                               torch.from_numpy(x_all[r]).to(device),
                               torch.from_numpy(y_all[r]).to(device)))
    return (torch.stack(losses).cpu(),
            {n: {k: v.detach().cpu() for k, v in layer.items()}
             for n, layer in model.params().items()})


@pytest.mark.parametrize("dtype,key", [("float32", "fused_split_keyed"),
                                       ("bfloat16", "fused_mma_keyed")])
def test_two_ranks_on_the_card_are_the_two_replica_mesh_bitwise(
        cuda, tmp_path, dtype, key):
    import sys
    from test_torch_port_world import _run_world
    n = 2
    _run_world([sys.executable, __file__, "--rank", str(tmp_path), dtype],
               world=n)
    runs = [torch.load(tmp_path / f"rank{r}.pt") for r in range(n)]
    shards = _world_rows(n)
    want = fused_step.launch_count[key]
    # the single-process mesh fed the world's rows in rank order
    losses, params = _world_steps(fused_step.make_pallas_dp_train_step(
        (cuda,) * n, 0.01, dtype=dtype), cuda, lambda s: np.concatenate(
            [sh[s * 128:(s + 1) * 128] for sh in shards]))
    assert fused_step.launch_count[key] - want == n * WORLD_STEPS
    for run in runs:
        assert run["backend"] == ("gloo" if torch.cuda.device_count() < n
                                  else "nccl")
        assert run["launches"][key] == WORLD_STEPS
        # the masks are drawn in the kernel: no launch of the mask entry
        assert run["launches"]["threefry_mask"] == 0
        assert torch.equal(run["losses"], losses)
        for n_, layer in params.items():
            for k, v in layer.items():
                assert torch.equal(run["params"][n_][k], v), f"{n_}.{k}"


def test_two_rank_cli_on_the_card_prints_one_epoch_line(cuda, tmp_path):
    import sys
    from test_torch_port_world import _run_world
    ckpt = tmp_path / "model.pt"
    outs = _run_world([sys.executable, "-m", "pytorch_ddp_mnist_tpu_torch",
                       "train", "--parallel", "--wireup_method", "env",
                       "--limit", "2560", "--checkpoint", str(ckpt),
                       "--path", str(tmp_path / "no_mnist")], world=2,
                      cwd=tmp_path)
    assert outs[0][1].count("Epoch=0,") == 1 and "world=2 rank=0" in outs[0][1]
    assert "Epoch=" not in outs[1][1]
    assert ckpt.exists()
    assert "peak device memory" in outs[1][2]



# ---- the per-step loops captured as CUDA graphs (train/graphs.py) ----

GRAPH_ROWS, GRAPH_EPOCHS = 1024, 2


def _graph_data(device, n_rep=1, seed=3):
    split = synthetic_mnist(GRAPH_ROWS, seed=seed)
    x = torch.from_numpy(scan.resident_images(split.images)).to(device)
    y = torch.from_numpy(split.labels.astype(np.int32)).to(device)
    rng = np.random.default_rng(seed)
    idxs = np.stack([rng.permutation(GRAPH_ROWS).reshape(-1, 128 * n_rep)
                     for _ in range(GRAPH_EPOCHS)]).astype(np.int32)
    return x, y, idxs


def _counted(fn):
    """fn()'s result, the launch counts it added and its captures."""
    from pytorch_ddp_mnist_tpu_torch.train import graphs
    before, caps = dict(fused_step.launch_count), graphs.counts["captures"]
    out = fn()
    torch.cuda.synchronize()
    added = {k: v - before[k] for k, v in fused_step.launch_count.items()
             if v != before[k]}
    return out, added, graphs.counts["captures"] - caps


def _eager_cached_run(params, key, x, y, idxs, kernel, dtype, mesh):
    """make_run_fn's (params', key', losses (E, S)) on scan.CachedSteps
    built with eager=True: the same step without the graph."""
    params = scan._clone(params)
    steps = scan.CachedSteps(params, x, y, idxs.shape[1:], 0.01, kernel,
                             torch.bfloat16 if dtype == "bfloat16"
                             else torch.float32, mesh, eager=True)
    losses = []
    for idx in idxs:
        key, ls = steps.epoch(key, idx)
        losses.append(ls)
    return params, key, torch.stack(losses)


@pytest.mark.parametrize("mesh", [None, 4], ids=["serial", "mesh4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["xla", "pallas", "pallas_rng"])
def test_graph_cached_loop_is_the_eager_loop_bitwise(cuda, kernel, dtype,
                                                     mesh):
    x, y, idxs = _graph_data(cuda, mesh or 1)
    params = MLP.from_seed(0).to(cuda).params()
    replicas = None if mesh is None else (cuda,) * mesh
    run = (scan.make_run_fn(0.01, kernel=kernel, dtype=dtype)
           if mesh is None else
           scan.make_dp_run_fn(replicas, 0.01, kernel=kernel, dtype=dtype))
    runs = [_counted(lambda: run(params, threefry.key_data(1), x, y, idxs)),
            _counted(lambda: _eager_cached_run(
                params, threefry.key_data(1), x, y, idxs, kernel, dtype,
                replicas))]
    (got, got_n, got_caps), (want, want_n, want_caps) = runs
    assert (got_caps, want_caps) == (1, 0)
    assert got_n == want_n and sum(got_n.values()) > 0
    assert got[1] == want[1] and torch.equal(got[2], want[2])
    assert torch.isfinite(got[2]).all()
    for n in got[0]:
        for k in got[0][n]:
            assert torch.equal(got[0][n][k], want[0][n][k]), f"{n}.{k}"


def _streaming_loader(split):
    from pytorch_ddp_mnist_tpu_torch.data.loader import BatchLoader
    from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
    return BatchLoader(normalize_images(split.images), split.labels,
                       ShardedSampler(GRAPH_ROWS, seed=42), 128)


def _eager_fit(step, model, key, loader):
    """fit's captured epochs (keys, batches through device_prefetch, the
    step loop, the loss fetch) on loop._captured_steps built with
    eager=True: (key', per-epoch losses)."""
    from pytorch_ddp_mnist_tpu_torch.data.loader import device_prefetch
    from pytorch_ddp_mnist_tpu_torch.train import loop
    nsteps = len(loader)
    device = next(model.parameters()).device
    steps, slots, keys = loop._captured_steps(step, model, nsteps, 128,
                                              device, eager=True)
    pinned = tuple(torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
                   for s in slots)
    history = []
    for epoch in range(GRAPH_EPOCHS):
        loader.sampler.set_epoch(epoch)
        key, words = step.key_words(key, nsteps)
        keys.load(words)
        steps.start_epoch()
        for _ in device_prefetch(iter(loader), slots, pinned):
            steps.step()
        history.append(steps.losses().cpu().numpy())
    return key, history


@pytest.mark.parametrize("kind,dtype", [("pallas", "float32"),
                                        ("pallas", "bfloat16"),
                                        ("xla", "float32")])
def test_graph_streaming_fit_is_the_eager_loop_bitwise(cuda, kind, dtype):
    from pytorch_ddp_mnist_tpu_torch.train import loop
    split = synthetic_mnist(GRAPH_ROWS, seed=6)
    test = synthetic_mnist(256, seed=7)

    def step():
        return (make_train_step(0.01) if kind == "xla" else
                fused_step.make_fused_train_step(0.01, dtype=dtype))
    model, eager_model = (MLP.from_seed(0).to(cuda) for _ in range(2))
    got, got_n, got_caps = _counted(lambda: loop.fit(
        loop.TrainState(model, threefry.key_data(1)), _streaming_loader(split),
        normalize_images(test.images), test.labels.astype(np.int32),
        epochs=GRAPH_EPOCHS, batch_size=128, train_step=step(),
        log=lambda line: None))
    want, want_n, want_caps = _counted(lambda: _eager_fit(
        step(), eager_model, threefry.key_data(1), _streaming_loader(split)))
    assert (got_caps, want_caps) == (1, 0)
    assert got_n == want_n and sum(got_n.values()) == \
        GRAPH_EPOCHS * GRAPH_ROWS // 128
    assert got[0].key == want[0]
    np.testing.assert_array_equal(np.stack(got[1]), np.stack(want[1]))
    for a, b in zip(model.parameters(), eager_model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["cached", "streaming"])
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_graph_one_rank_world_keeps_the_eager_loop_bitwise(cuda, backend,
                                                           kind):
    # a WorldMesh of one rank is a world: its mean is a collective, which
    # is not captured; it stays bitwise the captured 1-replica mesh
    import torch.distributed as dist
    from test_torch_port_world import _free_port
    from pytorch_ddp_mnist_tpu_torch.parallel.mesh import WorldMesh
    from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
    from pytorch_ddp_mnist_tpu_torch.train import loop
    split = synthetic_mnist(GRAPH_ROWS, seed=6)
    test = synthetic_mnist(256, seed=7)
    x_test = normalize_images(test.images)
    y_test = test.labels.astype(np.int32)

    def run(mesh):
        model = MLP.from_seed(0).to(cuda)
        if kind == "cached":
            key, history = scan.fit_cached(
                model, threefry.key_data(1), split.images,
                split.labels.astype(np.int32),
                ShardedSampler(GRAPH_ROWS, seed=42), x_test, y_test,
                epochs=GRAPH_EPOCHS, batch_size=128, lr=0.01, kernel="pallas",
                mesh=mesh, log=lambda line: None)
        else:
            state, history = loop.fit(
                loop.TrainState(model, threefry.key_data(1)),
                _streaming_loader(split), x_test, y_test,
                epochs=GRAPH_EPOCHS, batch_size=128,
                train_step=fused_step.make_pallas_dp_train_step(mesh, 0.01),
                log=lambda line: None)
            key = state.key
        return key, np.stack(history), [p.detach().clone()
                                        for p in model.parameters()]

    want, want_n, want_caps = _counted(lambda: run((cuda,)))
    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        assert dist.get_backend() == backend
        got, got_n, got_caps = _counted(lambda: run(
            WorldMesh([cuda], world_size=1, rank=0)))
    finally:
        dist.destroy_process_group()
    assert (want_caps, got_caps) == (1, 0)
    assert got_n == want_n and got_n.get("fused_split_keyed") == \
        GRAPH_EPOCHS * GRAPH_ROWS // 128
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["xla", "pallas", "pallas_rng"])
def test_graph_replay_on_new_indices_and_keys_is_the_eager_epoch(cuda,
                                                                 kernel):
    # captured on epoch 0's buffers; epoch 1 loads new rows and keys into
    # the same buffers, and its replays must read them
    x, y, idxs = _graph_data(cuda, seed=8)
    params = scan._clone(MLP.from_seed(0).to(cuda).params())
    steps = scan.CachedSteps(params, x, y, idxs.shape[1:], 0.01, kernel,
                             torch.float32)
    key, _ = steps.epoch(threefry.key_data(2), idxs[0])
    state = scan._clone(params)
    eager = scan.CachedSteps(state, x, y, idxs.shape[1:], 0.01, kernel,
                             torch.float32, eager=True)
    got_key, got = steps.epoch(key, idxs[1])
    want_key, want = eager.epoch(key, idxs[1])
    assert steps.loop.graph is not None and eager.loop.graph is None
    assert got_key == want_key and torch.equal(got, want)
    for n in params:
        for k in params[n]:
            assert torch.equal(params[n][k], state[n][k]), f"{n}.{k}"


@pytest.mark.parametrize("batch,dtype,design", [
    (128, torch.float32, "split"), (96, torch.float32, "split"),
    (3, torch.float32, "split"), (128, torch.bfloat16, "mma"),
    (96, torch.bfloat16, "mma"), (3, torch.bfloat16, "mma"),
    (256, torch.float32, "rows"), (256, torch.bfloat16, "rows")])
def test_graph_device_seed_forms_are_the_scalar_seed_forms(cuda, batch, dtype,
                                                           design):
    params, x, y, _ = _inputs(batch, batch, cuda)
    x = x.to(dtype)
    assert fused_step.fused_design(dtype, True, batch) == design
    seeds = [0, 1, 0x7FFFFFFF, 0x80000000, 0x9E3779B9, 0xFFFFFFFF]
    table = threefry.to_int32_words([(s, 77) for s in seeds]).to(cuda)
    for s, row in zip(seeds, table):
        got = fused_step.fused_loss_and_grads_rng(params, x, y, row)
        want = fused_step.fused_loss_and_grads_rng(params, x, y, s)
        for a, b in zip(_k1_leaves(*got), _k1_leaves(*want)):
            assert torch.equal(a, b), (design, batch, s)
    # a captured call reads the seed word the row holds at replay
    row = table[0].clone()
    out = {}
    fused_step.fused_loss_and_grads_rng(params, x, y, row)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out["r"] = fused_step.fused_loss_and_grads_rng(params, x, y, row)
    for s, src in zip(seeds[1:3], table[1:3]):
        row.copy_(src)
        graph.replay()
        want = fused_step.fused_loss_and_grads_rng(params, x, y, s)
        for a, b in zip(_k1_leaves(*out["r"]), _k1_leaves(*want)):
            assert torch.equal(a, b), (design, batch, s)


def test_graph_capture_of_a_syncing_body_raises_by_name(cuda):
    from pytorch_ddp_mnist_tpu_torch.train import graphs
    state = {"w": torch.ones(4, device=cuda)}

    def body(state, cursor, losses):
        losses.index_copy_(0, cursor.view(1), state["w"][:1])
        if float(state["w"].sum()) > 0:     # a host sync
            cursor.add_(1)

    loop = graphs.StepLoop(body, state, 3, cuda, capture=True,
                           what="the syncing test step")
    before = graphs.counts["captures"]
    with pytest.raises(RuntimeError, match="the syncing test step: "
                                           "capturing the step"):
        loop.step()
    assert graphs.counts["captures"] == before and loop.graph is None
    # the card is usable afterwards
    assert float(torch.ones(2, device=cuda).sum()) == 2.0

if __name__ == "__main__":
    import sys
    if sys.argv[1] == "--rank":
        _world_rank(sys.argv[2], sys.argv[3])
