"""The port's data plane against the JAX package's: the NetCDF writer and
reader (data/netcdf.py), the native reader core (csrc/reader.cc through
data/native.py), the sharded loader, `convert`, `download` and the
trainer's `--netcdf` / `--download` paths.

Tolerances: every array, file and batch is compared bitwise; the epoch
line of `train --netcdf` against the JAX CLI's at rtol 1e-5 (the two
trainers' f32 products sum in other orders), and against the port's own
IDX run on the same bytes bitwise (the same text)."""

import gzip
import hashlib
import http.server
import os
import re
import threading

import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.cli.train import main as jax_train_main
from pytorch_ddp_mnist_tpu.data import convert as jax_convert
from pytorch_ddp_mnist_tpu.data import loader as jax_loader
from pytorch_ddp_mnist_tpu.data import netcdf as jax_netcdf
from pytorch_ddp_mnist_tpu.data.idx import write_idx
from pytorch_ddp_mnist_tpu.data.mnist import synthetic_mnist
from pytorch_ddp_mnist_tpu.parallel.sampler import ShardedSampler as JaxSampler
from pytorch_ddp_mnist_tpu_torch import __main__ as port_front
from pytorch_ddp_mnist_tpu_torch.cli.train import main as port_train_main
from pytorch_ddp_mnist_tpu_torch.data import convert, download, loader, native
from pytorch_ddp_mnist_tpu_torch.data import mnist, netcdf
from pytorch_ddp_mnist_tpu_torch.ops import _build
from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler

LINE_RTOL = 1e-5
_NUM = r"([-0-9.e]+)"
_LINE = re.compile(rf"^Epoch=(\d+), train_loss={_NUM}, val_loss={_NUM}  "
                   rf"\[mean_train={_NUM} mean_val={_NUM} acc={_NUM} ")


@pytest.fixture
def core():
    """The native reader core, built here by g++ (skips where there is no
    C++ toolchain, as the JAX package's native tests do)."""
    if not native.native_available():
        pytest.skip(f"no native reader core: {native.native_build_error()}")
    return native


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------------- convert ---

def test_convert_synthetic_writes_the_jax_converters_bytes(tmp_path, capsys):
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    assert port_front.main(["convert", "--synthetic", "300:17",
                            "--out_dir", str(ours)]) == 0
    assert "wrote" in capsys.readouterr().out
    jax_convert.convert("", str(ref), synthetic="300:17")
    for name in convert.OUT_NAMES:
        assert _bytes(ours / name) == _bytes(ref / name)
    assert convert.OUT_NAMES == jax_convert.OUT_NAMES


def test_convert_from_idx_is_byte_identical_and_names_missing_files(
        tmp_path):
    idx_dir = tmp_path / "idx"
    idx_dir.mkdir()
    for prefix, n, seed in (("train", 41, 3), ("t10k", 9, 4)):
        split = synthetic_mnist(n, seed=seed)
        write_idx(str(idx_dir / f"{prefix}-images-idx3-ubyte"), split.images)
        write_idx(str(idx_dir / f"{prefix}-labels-idx1-ubyte"), split.labels)
    ours = convert.convert(str(idx_dir), str(tmp_path / "ours"))
    ref = jax_convert.convert(str(idx_dir), str(tmp_path / "ref"))
    assert [_bytes(p) for p in ours] == [_bytes(p) for p in ref]
    with pytest.raises(SystemExit, match="no IDX files"):
        convert.main(["--idx_dir", str(tmp_path / "none"),
                      "--out_dir", str(tmp_path / "x")])


# ------------------------------------------------ the writer and reader ---

@pytest.mark.parametrize("version", [1, 2, 5])
@pytest.mark.parametrize("rows", [1, 7, 33])
def test_netcdf_writer_and_reader_are_the_jax_modules(tmp_path, version,
                                                      rows):
    rng = np.random.default_rng(version * 100 + rows)
    variables = {
        "a": (("n", "w"), rng.integers(-99, 99, (rows, 3)).astype(np.int16)),
        "b": (("n",), rng.standard_normal(rows).astype(np.float64)),
        "c": (("n", "w"), rng.integers(0, 255, (rows, 3)).astype(np.uint8)),
    }
    dims = {"n": rows, "w": 3}
    ours, ref = str(tmp_path / "o.nc"), str(tmp_path / "r.nc")
    netcdf.write_netcdf(ours, dims, variables, version=version)
    jax_netcdf.write_netcdf(ref, dims, variables, version=version)
    assert _bytes(ours) == _bytes(ref)
    r, jr = netcdf.NetCDFReader(ours), jax_netcdf.NetCDFReader(ours)
    assert r.version == jr.version == version
    assert r.dimensions == jr.dimensions
    gather = rng.integers(0, rows, 2 * rows)
    for name in variables:
        whole = r.read(name)
        assert whole.dtype == jr.read(name).dtype
        assert whole.tobytes() == jr.read(name).tobytes()
        assert r.read(name, gather).tobytes() == \
            jr.read(name, gather).tobytes()


def test_reader_refuses_bad_files_and_rows(tmp_path):
    bad = tmp_path / "bad.nc"
    bad.write_bytes(b"HDF\x01" + b"\x00" * 16)
    with pytest.raises(ValueError, match="bad NetCDF magic"):
        netcdf.NetCDFReader(str(bad))
    path = str(tmp_path / "m.nc")
    split = synthetic_mnist(5, seed=0)
    netcdf.write_mnist_netcdf(path, split.images, split.labels)
    with pytest.raises(IndexError, match="out of range"):
        netcdf.NetCDFReader(path).read("images", [5])


# ----------------------------------------------------- the native core ---

@pytest.mark.parametrize("rows", [1, 63, 130])
def test_native_core_is_the_jax_reader_on_mnist_files(tmp_path, core, rows):
    split = synthetic_mnist(rows, seed=rows)
    path = str(tmp_path / "m.nc")
    jax_netcdf.write_mnist_netcdf(path, split.images, split.labels)
    want_images, want_labels = jax_netcdf.read_mnist_netcdf(path)
    rng = np.random.default_rng(rows)
    # a shuffled gather with duplicates and a contiguous run to coalesce
    gather = np.concatenate([rng.integers(0, rows, 40),
                             np.arange(rows)[: min(rows, 9)]])
    got_i, got_l = jax_netcdf.read_mnist_netcdf(path, gather)
    with core.NativeReader(path) as r:
        assert r.variables["images"] == ((rows, 28, 28), netcdf.NC_UBYTE)
        assert r.read("images").tobytes() == want_images.tobytes()
        assert r.read("labels").tobytes() == want_labels.tobytes()
        assert r.read("images", gather).tobytes() == got_i.tobytes()
        assert r.read("labels", gather).tobytes() == got_l.tobytes()


@pytest.mark.parametrize("version", [1, 2, 5])
def test_native_core_swaps_every_width_like_the_python_reader(tmp_path, core,
                                                              version):
    rng = np.random.default_rng(version)
    variables = {
        name: (("n", "w"), (rng.standard_normal((11, 5)) * 1000).astype(dt))
        for name, dt in (("i2", np.int16), ("i4", np.int32),
                         ("f4", np.float32), ("f8", np.float64),
                         ("u1", np.uint8))}
    path = str(tmp_path / "t.nc")
    jax_netcdf.write_netcdf(path, {"n": 11, "w": 5}, variables,
                            version=version)
    ref = jax_netcdf.NetCDFReader(path)
    idx = [10, 0, 3, 3, 4, 5]
    with core.NativeReader(path) as r:
        for name in variables:
            assert r.read(name).tobytes() == ref.read(name).tobytes()
            assert r.read(name, idx).tobytes() == \
                ref.read(name, idx).tobytes()
        with pytest.raises(IndexError, match="out of range"):
            r.read("i4", [11])
    bad = tmp_path / "bad.nc"
    bad.write_bytes(b"CDF\x09" + b"\x00" * 32)
    with pytest.raises(ValueError):
        core.NativeReader(str(bad))


def test_native_core_builds_into_the_build_tree_under_a_hashed_name(core):
    so, _ = _build.build_all(["reader"])["reader"]
    assert so.parent == _build.NATIVE_DIR and so.exists()
    assert re.fullmatch(r"reader-[0-9a-f]{16}\.so", so.name)
    assert _build._spec("reader") == ("reader.cc", _build.CXX_FLAGS)
    assert (_build.CSRC / "reader.cc").read_text().count("nr_read_rows") >= 1


def test_a_missing_compiler_is_named(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", "no-such-c++-compiler")
    monkeypatch.setattr(_build, "NATIVE_DIR", tmp_path / "native")
    with pytest.raises(_build.KernelBuildError, match="no-such-c"):
        _build.build_all(["reader"])


# ---------------------------------------------------------- the loader ---

def _loaders(tmp_path, n, world, rank, batch, workers, permutation):
    split = synthetic_mnist(n, seed=2)
    path = str(tmp_path / "mnist_train_images.nc")
    netcdf.write_mnist_netcdf(path, split.images, split.labels)
    ours = loader.NetCDFShardLoader(path, batch_size=batch,
                                    num_workers=workers)
    ref = jax_loader.NetCDFShardLoader(path, batch_size=batch,
                                       num_workers=workers)
    ours.sampler = ShardedSampler(n, num_replicas=world, rank=rank,
                                  permutation=permutation)
    ref.sampler = JaxSampler(n, num_replicas=world, rank=rank,
                             permutation=permutation)
    return split, ours, ref


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("world,rank", [(1, 0), (3, 2)])
def test_shard_loader_batches_are_the_jax_loaders(tmp_path, core, workers,
                                                  world, rank):
    split, ours, ref = _loaders(tmp_path, 301, world, rank, 32, workers,
                                "torch" if world > 1 else "pcg64")
    assert ours.core == "native" and ours.num_samples == 301
    for epoch in (0, 1):
        ours.sampler.set_epoch(epoch)
        ref.sampler.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        for (x, y), (xr, yr) in zip(got, want):
            assert x.dtype == np.float32 and y.dtype == np.int32
            assert x.tobytes() == xr.tobytes() and y.tobytes() == yr.tobytes()
    # and the in-memory loader over the same rows gives the same batches
    mem = loader.BatchLoader(mnist.normalize_images(split.images),
                             split.labels, ours.sampler, batch_size=32)
    for (x, y), (xm, ym) in zip(ours, mem):
        assert x.tobytes() == xm.tobytes() and y.tobytes() == ym.tobytes()


def test_shard_loader_names_the_python_core_where_the_native_is_off(
        tmp_path, monkeypatch):
    off = native._Core()
    off._tried, off.error = True, "no C++ compiler here"
    monkeypatch.setattr(native, "_CORE", off)
    assert not native.native_available()
    assert native.native_build_error() == "no C++ compiler here"
    split, ours, ref = _loaders(tmp_path, 70, 2, 1, 16, 0, "pcg64")
    assert ours.core == "python"
    for (x, y), (xr, yr) in zip(ours, ref):
        assert x.tobytes() == xr.tobytes() and y.tobytes() == yr.tobytes()
    head_i, head_l = ours.read_head(9)
    assert head_i.tobytes() == split.images[:9].tobytes()
    assert head_l.tobytes() == split.labels[:9].tobytes()


def test_shard_loader_read_ahead_raises_a_workers_error(tmp_path, core):
    _, ours, _ = _loaders(tmp_path, 96, 1, 0, 16, 2, "pcg64")
    ours.sampler = ShardedSampler(500)      # rows past the file's end
    with pytest.raises(IndexError, match="out of range"):
        list(ours)


# ------------------------------------------------------------ download ---

def _fixture_files(dirpath):
    """The four MNIST artifacts, tiny (8 train / 4 test), gzipped IDX.
    Returns {filename: md5}."""
    rng = np.random.default_rng(1)
    arrays = {
        "train-images-idx3-ubyte.gz": rng.integers(0, 256, (8, 28, 28)),
        "train-labels-idx1-ubyte.gz": rng.integers(0, 10, 8),
        "t10k-images-idx3-ubyte.gz": rng.integers(0, 256, (4, 28, 28)),
        "t10k-labels-idx1-ubyte.gz": rng.integers(0, 10, 4),
    }
    manifest = {}
    for name, arr in arrays.items():
        raw = os.path.join(dirpath, name[:-3])
        write_idx(raw, arr.astype(np.uint8))
        payload = gzip.compress(_bytes(raw), mtime=0)
        os.unlink(raw)
        with open(os.path.join(dirpath, name), "wb") as f:
            f.write(payload)
        manifest[name] = hashlib.md5(payload).hexdigest()
    return manifest


def _serve(docroot):
    handler = lambda *a, **kw: http.server.SimpleHTTPRequestHandler(  # noqa: E731
        *a, directory=str(docroot), **kw)
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_port}/"


@pytest.fixture
def mirror(tmp_path):
    """A fixture mirror over localhost HTTP, and a second one serving the
    same files cut in half; yields (url, truncated url, manifest)."""
    good, cut = tmp_path / "mirror", tmp_path / "truncated"
    good.mkdir()
    cut.mkdir()
    manifest = _fixture_files(str(good))
    for name in manifest:
        payload = _bytes(good / name)
        (cut / name).write_bytes(payload[: len(payload) // 2])
    servers = [_serve(good), _serve(cut)]
    try:
        yield servers[0][1], servers[1][1], manifest
    finally:
        for srv, _ in servers:
            srv.shutdown()
            srv.server_close()


DEAD = "http://127.0.0.1:9/"


def test_download_end_to_end_and_through_the_front_door(mirror, tmp_path,
                                                        monkeypatch, capsys):
    url, _, manifest = mirror
    dest = tmp_path / "data"
    download.download_mnist(str(dest), mirrors=[url], files=manifest)
    split = mnist.get_mnist(str(dest), train=True)
    assert split.images.shape == (8, 28, 28) and len(
        mnist.get_mnist(str(dest), train=False)) == 4
    assert "synthetic" not in capsys.readouterr().out
    monkeypatch.setattr(download, "MIRRORS", (url,))
    monkeypatch.setattr(download, "FILES", manifest)
    assert port_front.main(["download", "--root", str(tmp_path / "d2")]) == 0
    assert sorted(os.listdir(tmp_path / "d2")) == sorted(manifest)


def test_download_fails_over_past_a_bad_checksum(mirror, tmp_path):
    url, cut, manifest = mirror
    name = "train-images-idx3-ubyte.gz"
    with pytest.raises(download.DownloadError, match="checksum mismatch"):
        download.download_file(name, str(tmp_path / "d1"), mirrors=[url],
                               md5="0" * 32)
    out = download.download_file(name, str(tmp_path / "d2"),
                                 mirrors=[cut, DEAD, url],
                                 md5=manifest[name])
    assert hashlib.md5(_bytes(out)).hexdigest() == manifest[name]
    for d in ("d1", "d2"):
        assert [p for p in os.listdir(tmp_path / d)
                if p.endswith(".part")] == []
    # a warm file short-circuits: a dead mirror list proves no fetch
    assert download.download_file(name, str(tmp_path / "d2"), mirrors=[DEAD],
                                  md5=manifest[name]) == out


def test_all_mirrors_failing_names_each_and_the_command_exits_by_name(
        mirror, tmp_path, monkeypatch):
    _, cut, manifest = mirror
    name = "t10k-images-idx3-ubyte.gz"
    with pytest.raises(download.DownloadError) as e:
        download.download_file(name, str(tmp_path / "dst"),
                               mirrors=[cut, DEAD], md5=manifest[name])
    msg = str(e.value)
    assert cut + name in msg and DEAD + name in msg
    assert "checksum mismatch" in msg
    monkeypatch.setattr(download, "MIRRORS", (DEAD,))
    monkeypatch.setattr(download, "FILES", manifest)
    with pytest.raises(SystemExit, match="could not download"):
        download.main(["--root", str(tmp_path / "d3")])
    # get_mnist(download=True) with every mirror dead: the synthetic split
    got = mnist.get_mnist(str(tmp_path / "d4"), train=False, download=True,
                          quiet=True, synthetic_n=16)
    assert got.images.tobytes() == synthetic_mnist(16, seed=1).images.tobytes()


def test_train_download_fetches_then_trains_on_the_files(mirror, tmp_path,
                                                         monkeypatch, capsys):
    url, _, manifest = mirror
    monkeypatch.setattr(download, "MIRRORS", (url,))
    monkeypatch.setattr(download, "FILES", manifest)
    assert port_train_main(["--device", "cpu", "--download", "--path",
                            str(tmp_path / "dl"), "--batch_size", "4",
                            "--checkpoint", ""]) == 0
    out = capsys.readouterr().out
    assert "downloaded train-images-idx3-ubyte.gz" in out
    assert "synthetic" not in out and "Epoch=0" in out


# ------------------------------------------------------ train --netcdf ---

def _epoch_lines(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    out = capsys.readouterr().out
    return out, [_LINE.match(ln).groups() for ln in out.splitlines()
                 if ln.startswith("Epoch=")]


def _idx_and_nc(tmp_path, n_train, n_test):
    """The same synthetic split as IDX files and, through the port's
    `convert`, as .nc files: (idx dir, nc dir)."""
    idx_dir, nc = tmp_path / "idx", tmp_path / "nc"
    idx_dir.mkdir()
    for prefix, n, seed in (("train", n_train, 0), ("t10k", n_test, 1)):
        split = synthetic_mnist(n, seed=seed)
        write_idx(str(idx_dir / f"{prefix}-images-idx3-ubyte"), split.images)
        write_idx(str(idx_dir / f"{prefix}-labels-idx1-ubyte"), split.labels)
    convert.main(["--idx_dir", str(idx_dir), "--out_dir", str(nc)])
    return idx_dir, nc


def test_train_netcdf_is_the_jax_clis_line_and_the_idx_runs(tmp_path,
                                                            capsys):
    idx_dir, nc = _idx_and_nc(tmp_path, 1500, 500)
    common = ["--kernel", "xla", "--limit", "1024", "--seed", "3",
              "--checkpoint", ""]
    jax_out, jax_lines = _epoch_lines(
        jax_train_main, ["--netcdf", "--path", str(nc), *common], capsys)
    out, lines = _epoch_lines(
        port_train_main, ["--device", "cpu", "--netcdf", "--path", str(nc),
                          *common], capsys)
    assert "1024 of 1500 rows, read by the" in out
    assert len(lines) == len(jax_lines) == 1
    np.testing.assert_allclose([float(v) for v in lines[0][1:5]],
                               [float(v) for v in jax_lines[0][1:5]],
                               rtol=LINE_RTOL)
    assert lines[0][5] == jax_lines[0][5]
    # the IDX files of the same bytes: the same text
    _, idx_lines = _epoch_lines(
        port_train_main, ["--device", "cpu", "--path", str(idx_dir),
                          *common], capsys)
    assert idx_lines == lines


def test_train_netcdf_cached_is_the_idx_cached_run(tmp_path, capsys):
    idx_dir, nc = _idx_and_nc(tmp_path, 1000, 300)
    common = ["--device", "cpu", "--cached", "--limit", "640",
              "--batch_size", "64", "--checkpoint", ""]
    _, nc_lines = _epoch_lines(
        port_train_main, ["--netcdf", "--path", str(nc), *common], capsys)
    _, idx_lines = _epoch_lines(
        port_train_main, ["--path", str(idx_dir), *common], capsys)
    assert len(nc_lines) == 1 and nc_lines == idx_lines


def test_train_netcdf_refuses_missing_files_by_name(tmp_path):
    with pytest.raises(SystemExit, match="mnist_train_images.nc not found"):
        port_train_main(["--device", "cpu", "--netcdf", "--path",
                         str(tmp_path), "--checkpoint", ""])


# --------------------------------------------------------------- bench ---

def test_bench_stream_and_accuracy_fields_on_a_tiny_run(core):
    # plumbing only: a CPU time is no device number and is not recorded
    from pytorch_ddp_mnist_tpu_torch import bench
    out = bench.run_stream_bench(num_workers=2, trials=2, n_train=700)
    assert out["metric"] == "mnist_netcdf_stream_images_per_sec"
    assert out["core"] == "native" and out["value"] > 0
    assert not {"tflops", "mfu_pct_vs_bf16_peak"} & set(out)
    acc = bench.run_accuracy_bench(torch.device("cpu"), "pallas_epoch", "float32", 1,
                                   "rbg", 1, n_train=256, n_test=64)
    assert acc["metric"] == "mnist_1epoch_test_accuracy"
    assert 0 <= acc["value"] <= 1 and acc["vs_baseline"] > 0
    assert acc["mean_val_loss"] > 0 and acc["ref_mean_val_loss"] > 0
    assert bench.ACCURACY_EPOCHS == 10


@pytest.mark.parametrize("argv,match", [
    (["--mode", "stream", "--kernel", "xla"], "--kernel xla is a train-mode"),
    (["--mode", "accuracy", "--batch_size", "64"], "--batch_size 64"),
    (["--mode", "train", "--num_workers", "2"], "stream-mode knob"),
    (["--mode", "train", "--input_workers", "2"], "input-mode knob"),
])
def test_bench_modes_refuse_knobs_they_never_read(argv, match, capsys):
    from pytorch_ddp_mnist_tpu_torch import bench
    with pytest.raises(SystemExit) as e:
        bench.main(argv)
    assert match in str(e.value.code) + capsys.readouterr().err


def test_bench_modes_need_a_card(monkeypatch):
    from pytorch_ddp_mnist_tpu_torch import bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("stream", "accuracy"):
        with pytest.raises(SystemExit, match="no CUDA card"):
            bench.main(["--mode", mode])
