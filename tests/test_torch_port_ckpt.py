"""The port's flax-msgpack codec (train/msgpack.py) and step-checkpoint
manager (train/ckpt_manager.py), held against flax and the JAX package's
manager:

  * the payload bytes equal `flax.serialization.to_bytes` for the MLP, a
    zoo `deep_mlp` and the int8 residual, and flax reads the port's bytes;
  * a directory the port writes restores under the JAX manager (params,
    key words, epoch, offset, residual and meta equal), and a JAX
    directory under the port's;
  * on directories torn the same way (a truncated or CRC-flipped payload,
    a missing manifest or payload, a NaN checkpoint, a pinned one past
    rotation, a torn residual) both managers pick the same step;
  * `ckpt_save_io` leaves the directory consistent; the registry metrics;
    the geometry refusal and the manifest peek.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.models.zoo import resolve_model as jax_resolve
from pytorch_ddp_mnist_tpu.train import ckpt_manager as jax_cm
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params
from pytorch_ddp_mnist_tpu_torch.models.zoo import resolve_model
from pytorch_ddp_mnist_tpu_torch.telemetry import get_registry
from pytorch_ddp_mnist_tpu_torch.train import ckpt_manager as cm
from pytorch_ddp_mnist_tpu_torch.train import msgpack
from pytorch_ddp_mnist_tpu_torch.train.checkpoint import (CheckpointError,
                                                          host_params,
                                                          load_checkpoint,
                                                          params_to_bytes,
                                                          save_checkpoint)
from pytorch_ddp_mnist_tpu_torch.utils import faultpoints

KEY = np.asarray([0x9E3779B9, 0x8000_0001], np.uint32)
META = {"global_batch": 64, "limit": 512, "sampler_rng": "pcg64",
        "model": "mlp", "param_scale": 1}


def _jax_np(seed=0):
    return jax.tree_util.tree_map(np.asarray, init_mlp(jax.random.key(seed)))


def _port(seed=0):
    return {n: {k: v.detach().clone() for k, v in layer.items()}
            for n, layer in from_jax_params(_jax_np(seed)).params().items()}


def _resid(n=4, elems=1024, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (n, elems)).astype(np.float32)


def _same(a, b):
    for n in a:
        for k in a[n]:
            np.testing.assert_array_equal(np.asarray(a[n][k]),
                                          np.asarray(b[n][k]))


# -- the codec --------------------------------------------------------------

@pytest.mark.parametrize("what", ["mlp", "deep_mlp", "resid", "scalars"])
def test_payload_bytes_are_flax_to_bytes(what):
    if what == "mlp":
        tree = _jax_np()
        ours = params_to_bytes(from_jax_params(tree).params())
    elif what == "deep_mlp":
        spec = resolve_model("deep_mlp", 1)
        tree = host_params(spec.from_seed(3).params())
        ours = params_to_bytes(spec.from_seed(3).params())
        jax_tree = jax.tree_util.tree_map(np.asarray, jax_resolve(
            "deep_mlp", 1).init(jax.random.key(3)))
        assert serialization.to_bytes(jax_tree) == ours   # the JAX init too
    elif what == "resid":
        tree = _resid()
        ours = msgpack.to_bytes(tree)
    else:
        tree = {"a": np.float32(1.5), "b": np.arange(3, dtype=np.uint32),
                "c": {"d": np.zeros((0, 2), np.float32)}}
        ours = msgpack.to_bytes(tree)
    assert ours == serialization.to_bytes(tree)
    back = serialization.msgpack_restore(ours)
    mine = msgpack.unpackb(serialization.to_bytes(tree))
    if isinstance(tree, dict):
        for n in tree:
            if isinstance(tree[n], dict):
                _same({n: tree[n]}, {n: back[n]})
                _same({n: tree[n]}, {n: mine[n]})
    else:
        np.testing.assert_array_equal(mine, tree)


@pytest.mark.parametrize("cut", [1, 100, 5000])
def test_torn_msgpack_raises_checkpoint_error_by_name(tmp_path, cut):
    path = str(tmp_path / "m.msgpack")
    save_checkpoint(path, _port())
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-cut])
    with pytest.raises(CheckpointError, match="cannot decode checkpoint"):
        load_checkpoint(path)


def test_msgpack_checkpoint_round_trips_with_the_jax_package(tmp_path):
    from pytorch_ddp_mnist_tpu.train import checkpoint as jax_ckpt
    ours, theirs = str(tmp_path / "p.msgpack"), str(tmp_path / "j.msgpack")
    save_checkpoint(ours, _port(1))
    jax_ckpt.save_checkpoint(theirs, _jax_np(1))
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    _same(jax_ckpt.load_checkpoint(ours, _jax_np()), _jax_np(1))
    _same(load_checkpoint(theirs, _port()), _port(1))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(theirs, resolve_model("mlp", 2).from_seed(0).params())


# -- the manager against the JAX manager -----------------------------------

def _fill(save, d, n=4, resid=False):
    for i, step in enumerate(range(3, 3 * n + 1, 3)):
        save(d, step, i, resid)


def _port_save(d, step, i, resid=False, params=None):
    cm.CheckpointManager(d, keep=10).save(
        params if params is not None else _port(i), KEY + i, "threefry2x32",
        step=step, epoch=step // 8, offset=step % 8, meta=META,
        resid=_resid(seed=i) if resid else None)


def _jax_save(d, step, i, resid=False, params=None):
    jax_cm.CheckpointManager(d, keep=10).save(
        params if params is not None else _jax_np(i), KEY + i,
        "threefry2x32", step=step, epoch=step // 8, offset=step % 8,
        meta=META, resid=_resid(seed=i) if resid else None)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_directory_restores_under_the_other_manager(tmp_path, writer):
    d = str(tmp_path / "steps")
    _fill(_port_save if writer == "port" else _jax_save, d, resid=True)
    names = sorted(os.listdir(d))
    got = cm.CheckpointManager(d).restore_latest(_port())
    want = jax_cm.CheckpointManager(d).restore_latest(_jax_np())
    for a, b in ((got, want),):
        assert (a.step, a.epoch, a.offset, a.impl, a.meta) == (
            b.step, b.epoch, b.offset, b.impl, b.meta) == (
            12, 1, 4, "threefry2x32", META)
        np.testing.assert_array_equal(a.key_data, b.key_data)
        np.testing.assert_array_equal(a.key_data, KEY + 3)
        np.testing.assert_array_equal(a.resid, b.resid)
        np.testing.assert_array_equal(a.resid, _resid(seed=3))
        _same(a.params, b.params)
        _same(a.params, _jax_np(3))
    assert sorted(os.listdir(d)) == names      # restore only reads
    assert cm.peek_latest_meta(d) == jax_cm.peek_latest_meta(d)


def test_both_managers_write_the_same_files(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _fill(_port_save, a, resid=True)
    _fill(_jax_save, b, resid=True)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        x, y = (open(os.path.join(p, name), "rb").read() for p in (a, b))
        if name.endswith(".json"):
            x, y = json.loads(x), json.loads(y)
            x.pop("t_wall"), y.pop("t_wall")
        assert x == y, name


def _tear(d, how):
    """Damage the newest checkpoint (step 12) of a 4-checkpoint directory."""
    man = os.path.join(d, "step_00000012.json")
    pay = os.path.join(d, "step_00000012.msgpack")
    if how == "truncated":
        blob = open(pay, "rb").read()
        open(pay, "wb").write(blob[:len(blob) // 2])
    elif how == "crc":
        blob = bytearray(open(pay, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(pay, "wb").write(bytes(blob))
    elif how == "no_manifest":
        os.remove(man)
    elif how == "no_payload":
        os.remove(pay)
    elif how == "bad_manifest":
        open(man, "w").write("{not json")
    elif how == "missing_fields":
        rec = json.load(open(man))
        del rec["crc32"]
        json.dump(rec, open(man, "w"))
    elif how == "torn_resid":
        rp = os.path.join(d, "step_00000012.resid.msgpack")
        blob = open(rp, "rb").read()
        open(rp, "wb").write(blob[:-7])


@pytest.mark.parametrize("how", ["truncated", "crc", "no_manifest",
                                 "no_payload", "bad_manifest",
                                 "missing_fields", "torn_resid"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_torn_directories_fall_back_to_the_same_step(tmp_path, how, writer):
    d = str(tmp_path / "steps")
    _fill(_port_save if writer == "port" else _jax_save, d, resid=True)
    _tear(d, how)
    got = cm.CheckpointManager(d).scan_restorable(_port())
    want = jax_cm.CheckpointManager(d).scan_restorable(_jax_np())
    assert got.best.step == want.best.step == 9
    assert len(got.tried) == len(want.tried)
    _same(got.best.params, want.best.params)


def _nan(tree):
    out = {n: {k: np.array(v) for k, v in layer.items()}
           for n, layer in tree.items()}
    out["fc2"]["w"][0, 0] = np.nan
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_nan_and_pinned_checkpoints_choose_alike(tmp_path, writer, capsys):
    save = _port_save if writer == "port" else _jax_save
    d = str(tmp_path / "steps")
    for i, step in enumerate((3, 6, 9)):
        save(d, step, i)
    for step in (12, 15):       # a diverged run keeps committing
        p = _nan(_jax_np(step))
        save(d, step, 0, params=(p if writer == "jax" else
                                 {n: {k: torch.from_numpy(v)
                                      for k, v in layer.items()}
                                  for n, layer in p.items()}))
    got = cm.CheckpointManager(d).restore_latest(_port())
    want = jax_cm.CheckpointManager(d).restore_latest(_jax_np())
    assert got.step == want.step == 9
    # every intact one non-finite: the newest, with a warning, alike
    for step in (3, 6, 9):
        os.remove(os.path.join(d, f"step_{step:08d}.json"))
    assert cm.CheckpointManager(d).restore_latest(_port()).step == \
        jax_cm.CheckpointManager(d).restore_latest(_jax_np()).step == 15
    assert "non-finite" in capsys.readouterr().err
    # a pinned checkpoint outlives rotation under both managers
    p2 = str(tmp_path / "pinned")
    for mgr_mod, tree in ((cm, _port), (jax_cm, _jax_np)):
        shutil.rmtree(p2, ignore_errors=True)
        mgr = mgr_mod.CheckpointManager(p2, keep=2)
        mgr.save(tree(0), KEY, "threefry2x32", step=1, epoch=0, offset=1,
                 pin=True)
        for step in (2, 3, 4, 5):
            mgr.save(tree(step), KEY, "threefry2x32", step=step, epoch=0,
                     offset=step)
        assert mgr.steps() == [1, 4, 5]
        for step in (4, 5):     # the rest torn: the pinned one is next
            os.remove(os.path.join(p2, f"step_{step:08d}.msgpack"))
    assert cm.CheckpointManager(p2).restore_latest(_port()).step == \
        jax_cm.CheckpointManager(p2).restore_latest(_jax_np()).step == 1


def test_no_intact_checkpoint_raises_naming_every_candidate(tmp_path):
    d = str(tmp_path / "steps")
    with pytest.raises(CheckpointError, match="no committed step"):
        cm.CheckpointManager(d).restore_latest(_port())
    _fill(_port_save, d, n=2)
    for step in (3, 6):
        os.remove(os.path.join(d, f"step_{step:08d}.msgpack"))
    with pytest.raises(CheckpointError, match="tried 2") as e:
        cm.CheckpointManager(d).restore_latest(_port())
    assert "step_00000003.msgpack" in str(e.value)


def test_save_io_fault_leaves_the_directory_consistent(tmp_path):
    d = str(tmp_path / "steps")
    mgr = cm.CheckpointManager(d, keep=3)
    faultpoints.install("ckpt_save_io:step=6")
    try:
        mgr.save(_port(0), KEY, "threefry2x32", step=3, epoch=0, offset=3)
        before = sorted(os.listdir(d))
        with pytest.raises(CheckpointError, match="injected fault"):
            mgr.save(_port(1), KEY, "threefry2x32", step=6, epoch=0,
                     offset=6, resid=_resid())
        assert sorted(os.listdir(d)) == before       # nothing torn, no tmp
        mgr.save(_port(2), KEY, "threefry2x32", step=9, epoch=1, offset=1)
    finally:
        faultpoints.install()
    assert mgr.steps() == [3, 9]
    assert mgr.restore_latest(_port()).step == 9


def test_rotation_keeps_n_and_sweeps_the_debris_of_dead_writers(tmp_path):
    d = str(tmp_path / "steps")
    mgr = cm.CheckpointManager(d, keep=2)
    os.makedirs(d)
    for stray in ("step_00000001.msgpack.tmp.999999", "step_00000002.msgpack"):
        open(os.path.join(d, stray), "wb").write(b"x")
    reg = get_registry()
    saves = reg.histogram("checkpoint.save_s").snapshot()["n"]
    for step in (3, 6, 9):
        mgr.save(_port(step), KEY, "threefry2x32", step=step, epoch=0,
                 offset=step, resid=_resid())
    assert sorted(os.listdir(d)) == sorted(
        f"step_{s:08d}{ext}" for s in (6, 9)
        for ext in (".json", ".msgpack", ".resid.msgpack"))
    assert reg.histogram("checkpoint.save_s").snapshot()["n"] == saves + 3
    assert reg.counter("checkpoint.bytes").value > 0


def test_geometry_refusal_names_both_geometries():
    want = {**META, "global_batch": 128}
    got = cm.geometry_mismatch_message(META, want)
    jax_msg = jax_cm.geometry_mismatch_message(META, want)
    assert got.splitlines()[:4] == jax_msg.splitlines()[:4]
    assert "global_batch=64" in got and "global_batch=128" in got
    assert cm.geometry_mismatch_message(META, dict(META)) is None
