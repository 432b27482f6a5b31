"""Crash-consistent step checkpoints (port of
`pytorch_ddp_mnist_tpu/train/ckpt_manager.py`; its files, its manifest
schema and its fallback rules, so a directory either side writes restores
under the other's manager).

One checkpoint is two or three files in the manager's directory:

    step_00000012.msgpack        the params tree as flax msgpack: the bytes
                                 `flax.serialization.to_bytes` gives for
                                 the JAX package's params (train/msgpack.py)
    step_00000012.resid.msgpack  with `--ddp_comm int8` and error feedback:
                                 the (n_replicas, elems) f32 residual, flax
                                 msgpack of the array
    step_00000012.json           the manifest, the COMMIT record:
        {"v": 1, "step": 12, "epoch": 1, "offset": 4,
         "key": [k0, k1], "impl": "threefry2x32",
         "payload": "step_00000012.msgpack", "bytes": N, "crc32": C,
         "meta": {...}, "t_wall": ...
         [, "resid_payload", "resid_bytes", "resid_crc32"] [, "pinned"]}

`step` counts the global steps done; (`epoch`, `offset`) is the sampler's
position: the epoch in progress and the batches of it already taken (the
sampler's permutation is a function of its seed and epoch, so this pair
is its whole state). `key` holds the words of jax's threefry
`key_data` of the train key after those steps (ops/threefry.py keys are
those words). `meta` is the run geometry the CLI stamps
(`cli/train.py` `_run_geometry`).

Crash consistency:
  * a save writes the payload to a `.tmp.<pid>` file, fsyncs it and
    renames it, then the residual the same way, then the manifest to its
    own temp file and renames it (the commit), then fsyncs the directory.
    A crash at any point leaves a committed checkpoint or an uncommitted
    one, never a manifest that points at nothing;
  * `restore_latest` walks the manifests newest first and takes the first
    INTACT and FINITE one: the manifest parses and has every field, the
    payload's size and CRC32 match it and it decodes, the residual the
    same; a checkpoint whose float params hold NaN or Inf is passed over
    for an older finite one (and taken only when no finite one is left).
    Each rejected candidate goes to the flight recorder
    (`checkpoint_fallback`) and to stderr;
  * rotation keeps the newest `keep` checkpoints: a manifest is removed
    before its payloads (uncommit first), pinned checkpoints are never
    removed, and the debris a killed writer leaves (`.tmp.<pid>` files of
    dead writers, payloads whose manifest never committed) is swept.

Each save records `checkpoint.save_s` (a histogram) and
`checkpoint.bytes` (a counter) in the port's registry
(telemetry/registry.py). The `ckpt_save` fault point
(utils/faultpoints.py, `ckpt_save_io`) fires just before the payload is
written: the save fails with CheckpointError and the directory stays as
it was.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
import zlib
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from . import msgpack
from .checkpoint import CheckpointError, params_from_bytes, params_to_bytes

_SCHEMA = 1
_NAME_RE = re.compile(r"^step_(\d{8})\.json$")
_PAYLOAD_RE = re.compile(r"^step_(\d{8})\.msgpack$")
_RESID_RE = re.compile(r"^step_(\d{8})\.resid\.msgpack$")
_FIELDS = ("step", "epoch", "offset", "key", "impl", "payload", "bytes",
           "crc32")


def _manifest_name(step: int) -> str:
    return f"step_{step:08d}.json"


def _payload_name(step: int) -> str:
    return f"step_{step:08d}.msgpack"


def _resid_name(step: int) -> str:
    return f"step_{step:08d}.resid.msgpack"


def _nonfinite_leaves(tree, prefix: str = "") -> List[str]:
    """Paths of the floating leaves that hold a NaN or an Inf."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _nonfinite_leaves(v, f"{prefix}/{k}")]
    t = torch.as_tensor(tree)
    if t.is_floating_point() and not bool(torch.isfinite(t).all()):
        return [prefix or "/"]
    return []


@dataclass
class StepCheckpoint:
    """One restored checkpoint: what a resume needs to replay the rest of
    the unbroken run bit for bit."""
    params: Any              # params tree of CPU tensors
    key_data: np.ndarray     # the train key's words (uint32)
    impl: str                # the PRNG engine those words belong to
    step: int                # global steps done
    epoch: int               # epoch in progress
    offset: int              # batches of it already taken
    path: str                # the manifest it came from
    resid: Any = None        # the int8 residual (n, elems) f32, or None
    meta: dict = None        # the stamped run geometry (may be empty)


@dataclass
class RestoreScan:
    """One newest-first walk (`scan_restorable`): `best`, the newest intact
    and finite checkpoint (or None); `newest_nonfinite`, the newest intact
    one whose params are not finite; `tried`, the defect of every
    candidate rejected before `best`."""
    best: Optional[StepCheckpoint]
    newest_nonfinite: Optional[StepCheckpoint]
    tried: List[str]


def geometry_mismatch_message(manifest_meta: dict,
                              requested: dict) -> Optional[str]:
    """The refusal of a resume whose run geometry differs from the one the
    manifest was stamped with (None when every stamped field matches). It
    names both geometries whole, then the fields that differ."""
    differ = sorted(k for k, v in manifest_meta.items()
                    if k in requested and requested[k] != v)
    if not differ:
        return None

    def fmt(src: dict) -> str:
        return ", ".join(f"{k}={src[k]!r}" for k in sorted(requested)
                         if k in src)

    return ("checkpoint was written under different run geometry; its "
            "(epoch, offset) would address different batches.\n"
            f"  checkpoint geometry: {fmt(manifest_meta)}\n"
            f"  requested geometry:  {fmt(requested)}\n"
            f"  differing: {', '.join(differ)}\n"
            "(a deliberate world-size change re-maps the checkpoint with "
            "--elastic --reshape, which the PyTorch package does not have "
            "yet: ROADMAP.md queue 1, item 13)")


def _read_manifest(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def peek_latest_meta(directory: str) -> Optional[dict]:
    """The newest committed manifest's position and geometry stamp, without
    reading its payload ({"step", "epoch", "offset", "meta"}); past
    unreadable or foreign manifests; None when nothing is committed."""
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    steps = sorted((int(m.group(1)) for n in names
                    if (m := _NAME_RE.match(n))), reverse=True)
    for step in steps:
        try:
            rec = _read_manifest(os.path.join(directory, _manifest_name(step)))
        except (OSError, ValueError):
            continue
        if rec.get("v") != _SCHEMA:
            continue
        return {"step": int(rec.get("step", step)),
                "epoch": int(rec.get("epoch", 0)),
                "offset": int(rec.get("offset", 0)),
                "meta": dict(rec.get("meta") or {})}
    return None


def _write_synced(path: str, data, mode: str = "wb") -> None:
    with open(path, mode) as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


class CheckpointManager:
    """Atomic, CRC-stamped, keep-last-N step checkpoints in one directory.
    The CALLER saves on rank 0 only (the params are the same on every
    replica); `restore_latest` only reads, from any rank."""

    def __init__(self, directory: str, *, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1; got {keep}")
        self.directory = directory
        self.keep = int(keep)

    # -- writing ------------------------------------------------------------

    def save(self, params, key_data, impl: str, *, step: int, epoch: int,
             offset: int, meta: Optional[dict] = None, pin: bool = False,
             resid=None) -> str:
        """Commit one checkpoint; returns its manifest's path. Fetches the
        params (and the residual) from the device: the save's one sync.
        Any I/O failure raises CheckpointError with the temp files removed
        and the committed checkpoints as they were. `pin` keeps it out of
        rotation."""
        from ..telemetry import get_registry
        from ..utils import faultpoints
        t0 = time.perf_counter()
        os.makedirs(self.directory, exist_ok=True)
        blob = params_to_bytes(params)
        rblob = None
        if resid is not None:
            rblob = msgpack.to_bytes(
                torch.as_tensor(resid).detach().to("cpu", torch.float32)
                .numpy())
        payload = os.path.join(self.directory, _payload_name(step))
        rpayload = os.path.join(self.directory, _resid_name(step))
        manifest = os.path.join(self.directory, _manifest_name(step))
        pid = os.getpid()
        tmp, rtmp, mtmp = (f"{p}.tmp.{pid}"
                           for p in (payload, rpayload, manifest))
        try:
            faultpoints.fire("ckpt_save", step=step, epoch=epoch)
            _write_synced(tmp, blob)
            os.replace(tmp, payload)
            if rblob is not None:
                _write_synced(rtmp, rblob)
                os.replace(rtmp, rpayload)
            record = {
                "v": _SCHEMA, "step": int(step), "epoch": int(epoch),
                "offset": int(offset),
                "key": [int(w) & 0xFFFFFFFF
                        for w in np.asarray(key_data).ravel()],
                "impl": str(impl), "payload": os.path.basename(payload),
                "bytes": len(blob), "crc32": zlib.crc32(blob),
                "meta": dict(meta or {}), "t_wall": time.time(),
            }
            if rblob is not None:
                record.update(resid_payload=os.path.basename(rpayload),
                              resid_bytes=len(rblob),
                              resid_crc32=zlib.crc32(rblob))
            if pin:
                record["pinned"] = True
            _write_synced(mtmp, json.dumps(record) + "\n", "w")
            os.replace(mtmp, manifest)          # the commit
            # the rotation below deletes durably: the commit's renames
            # must reach the disk first
            try:
                dfd = os.open(self.directory, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                pass
        except OSError as e:
            for stray in (tmp, rtmp, mtmp):
                try:
                    os.unlink(stray)
                except OSError:
                    pass
            raise CheckpointError(f"step checkpoint save failed at step "
                                  f"{step} ({payload}): {e}") from e
        self._rotate()
        reg = get_registry()
        reg.histogram("checkpoint.save_s").record(time.perf_counter() - t0)
        reg.counter("checkpoint.bytes").inc(len(blob) + len(rblob or b""))
        return manifest

    def _pinned(self, steps: List[int]) -> set:
        out = set()
        for step in steps:
            try:
                if _read_manifest(os.path.join(
                        self.directory, _manifest_name(step))).get("pinned"):
                    out.add(step)
            except (OSError, ValueError):
                pass
        return out

    def _rotate(self) -> None:
        """Drop the committed checkpoints beyond the newest `keep`, manifest
        first, pinned ones never; then sweep the temp files of dead writers
        and the payloads no live manifest names."""
        committed = self.steps()
        doomed = committed[:-self.keep]
        pinned = self._pinned(doomed)
        for step in doomed:
            if step in pinned:
                continue
            for name in (_manifest_name(step), _payload_name(step),
                         _resid_name(step)):
                try:
                    os.unlink(os.path.join(self.directory, name))
                except OSError:
                    pass
        live = set(committed[-self.keep:]) | pinned
        mine = f".{os.getpid()}"
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            if ".tmp." in name:
                stray = not name.endswith(mine)
            else:
                m = _PAYLOAD_RE.match(name) or _RESID_RE.match(name)
                stray = bool(m) and int(m.group(1)) not in live
            if stray:
                try:
                    os.unlink(os.path.join(self.directory, name))
                except OSError:
                    pass

    # -- reading ------------------------------------------------------------

    def steps(self) -> List[int]:
        """The committed steps (those with a manifest), ascending."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(m.group(1)) for n in names
                      if (m := _NAME_RE.match(n)))

    def _read_checked(self, rec: dict, name_key: str, bytes_key: str,
                      crc_key: str, what: str) -> bytes:
        path = os.path.join(self.directory, rec[name_key])
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise CheckpointError(f"{path}: unreadable {what}: {e}") from e
        if len(blob) != rec.get(bytes_key):
            raise CheckpointError(f"{path}: truncated {what} ({len(blob)} "
                                  f"bytes, manifest says "
                                  f"{rec.get(bytes_key)})")
        crc = zlib.crc32(blob)
        if crc != rec.get(crc_key):
            raise CheckpointError(
                f"{path}: {what} CRC32 mismatch ({crc:#010x}, manifest says "
                f"{rec.get(crc_key)!r}): a corrupt {what} of {len(blob)} "
                f"bytes")
        return blob

    def _load_intact(self, step: int, template) -> StepCheckpoint:
        """Load one committed checkpoint and check it; CheckpointError names
        what is wrong."""
        manifest = os.path.join(self.directory, _manifest_name(step))
        try:
            rec = _read_manifest(manifest)
        except (OSError, ValueError) as e:
            raise CheckpointError(f"{manifest}: unreadable manifest: "
                                  f"{e}") from e
        if not isinstance(rec, dict) or rec.get("v") != _SCHEMA:
            raise CheckpointError(f"{manifest}: unknown manifest schema "
                                  f"{rec.get('v') if isinstance(rec, dict) else rec!r}")
        missing = [k for k in _FIELDS if k not in rec]
        if missing:
            raise CheckpointError(f"{manifest}: manifest missing fields "
                                  f"{missing}")
        blob = self._read_checked(rec, "payload", "bytes", "crc32", "payload")
        path = os.path.join(self.directory, rec["payload"])
        try:
            params = params_from_bytes(blob, template, what=path)
        except ValueError as e:
            raise CheckpointError(str(e)) from e
        resid = None
        if rec.get("resid_payload"):
            rblob = self._read_checked(rec, "resid_payload", "resid_bytes",
                                       "resid_crc32", "residual payload")
            try:
                resid = np.asarray(msgpack.unpackb(rblob), np.float32)
            except (msgpack.MsgpackError, ValueError, TypeError) as e:
                raise CheckpointError(
                    f"{rec['resid_payload']}: cannot decode residual "
                    f"payload: {type(e).__name__}: {e}") from e
        return StepCheckpoint(
            params=params, key_data=np.asarray(rec["key"], np.uint32),
            impl=str(rec["impl"]), step=int(rec["step"]),
            epoch=int(rec["epoch"]), offset=int(rec["offset"]),
            path=manifest, resid=resid, meta=dict(rec.get("meta") or {}))

    def scan_restorable(self, template,
                        newer_than: Optional[int] = None) -> RestoreScan:
        """The newest-first walk that picks the newest intact and finite
        checkpoint (`restore_latest`'s; the serve reload watcher's when it
        is ported, so the two never disagree). `newer_than` stops the walk
        at that step."""
        from ..telemetry import flight
        tried: List[str] = []
        nonfinite: Optional[StepCheckpoint] = None
        for step in reversed(self.steps()):
            if newer_than is not None and step <= newer_than:
                break
            try:
                ckpt = self._load_intact(step, template)
            except CheckpointError as e:
                tried.append(str(e))
                flight.record("checkpoint_fallback", step=step,
                              error=str(e)[:500])
                print(f"[ckpt] skipping torn checkpoint at step {step}: {e}",
                      file=sys.stderr, flush=True)
                continue
            bad = _nonfinite_leaves(ckpt.params)
            if bad:
                msg = (f"{ckpt.path}: params contain non-finite values "
                       f"(e.g. {bad[0]}) — a diverged run's checkpoint")
                tried.append(msg)
                flight.record("checkpoint_fallback", step=step,
                              error=msg[:500])
                print(f"[ckpt] skipping non-finite checkpoint at step "
                      f"{step} (looking for the newest finite one)",
                      file=sys.stderr, flush=True)
                nonfinite = nonfinite or ckpt
                continue
            return RestoreScan(ckpt, nonfinite, tried)
        return RestoreScan(None, nonfinite, tried)

    def restore_latest(self, template) -> StepCheckpoint:
        """The newest intact and finite checkpoint; when every intact one
        is non-finite, the newest of those, with a warning; CheckpointError
        naming every candidate tried when none is intact."""
        from ..telemetry import flight
        if not self.steps():
            raise CheckpointError(f"{self.directory}: no committed step "
                                  f"checkpoints (no step_*.json manifests)")
        scan = self.scan_restorable(template)
        ckpt = scan.best
        if ckpt is None and scan.newest_nonfinite is not None:
            ckpt = scan.newest_nonfinite
            print(f"[ckpt] WARNING: every intact checkpoint holds non-finite "
                  f"params; restoring the newest anyway (step {ckpt.step}) — "
                  f"expect the resumed run to stay diverged",
                  file=sys.stderr, flush=True)
        if ckpt is None:
            raise CheckpointError(
                f"{self.directory}: no intact step checkpoint; tried "
                f"{len(scan.tried)}:\n"
                + "\n".join(f"  {t}" for t in scan.tried))
        flight.record("checkpoint_restore", step=ckpt.step, epoch=ckpt.epoch,
                      offset=ckpt.offset, fallbacks=len(scan.tried),
                      **({"nonfinite": True} if ckpt is not scan.best
                         else {}))
        return ckpt
