"""Checkpoint save/load under the DeepSpeed directory contract, a port of
``deepspeed_tpu/runtime/checkpointing.py``.

Layout of one save::

    <dir>/latest                         the newest tag's name (a hint)
    <dir>/<tag>/state-v<token>/...       the payload (below)
    <dir>/<tag>/state.current            names the live state-v<token>
    <dir>/<tag>/meta.json                tag, client_state, config
    <dir>/<tag>/manifest.json            size + sha256 of every file
    <dir>/<tag>/COMMITTED                written last

The payload replaces the JAX package's Orbax/TensorStore state with one
``.npy`` file per leaf, readable with numpy alone: the leaf named
``opt/exp_avg/layers/wq`` (JAX's flattened path) is the file
``state-v<token>/opt/exp_avg/layers/wq.npy``. numpy has no bfloat16, so
a bf16 leaf is stored exactly as its ``uint16`` bit pattern, and
``dtypes.json`` beside the leaves names every leaf's dtype (the scheme of
``save_16bit_model``). Readers use ``np.load(..., allow_pickle=False)``.

Crash safety is the JAX package's: a save writes a fresh ``state-v<token>``
directory and only then replaces ``state.current`` atomically, so a crash
at any point leaves the pointer naming the previous good version; the
integrity chain (``robustness/integrity.py``: manifest, then the commit
marker) follows, then ``latest`` and retention (``finalize_tag``).

Async saves: the port's optimizer updates its state in place, so a writer
that read live tensors would write a state torn across two steps.
``CheckpointEngine.save`` first copies every leaf to host memory (pinned
buffers and ``non_blocking`` copies on CUDA, then one event it waits on)
and only then hands the host arrays to a writer thread; the pointer
publish and the finalize run when that thread has finished (``wait``, or
the next save).
"""

import atexit
import json
import logging
import os
import shutil
import threading
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.robustness import events as rb_events
from deepspeed_tpu_torch.robustness import faults as rb_faults
from deepspeed_tpu_torch.robustness import integrity

logger = logging.getLogger("deepspeed_tpu_torch")

LATEST_FILE = "latest"
DTYPES_FILE = "dtypes.json"
#: meta.json's version key (JAX's meta carries none; readers of either
#: package read the keys they need and ignore this one)
META_SCHEMA = 1


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/c": leaf} of nested dicts, None leaves dropped (JAX's
    ``_flatten_dict``)."""
    out = {}
    for k, v in tree.items():
        key = k if not prefix else f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key))
        elif v is not None:
            out[key] = v
    return out


def dtype_name(dtype: torch.dtype) -> str:
    """"bfloat16", "float32", "int64", ... (numpy's and JAX's names)."""
    return str(dtype).replace("torch.", "")


def to_numpy_bits(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy, bf16 as its exact uint16 bit pattern."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_numpy_bits(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """Inverse of ``to_numpy_bits``: a uint16 array named "bfloat16"
    comes back as bf16, bit for bit."""
    # ascontiguousarray makes a 0-dim array 1-dim: keep the shape
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _pointer_file(path: str) -> str:
    return f"{path}.current"


def _read_pointer(path: str) -> Optional[str]:
    """Absolute path of the live version dir for ``path``, or None."""
    try:
        with open(_pointer_file(path)) as f:
            name = f.read().strip()
        return os.path.join(os.path.dirname(path), name)
    except FileNotFoundError:
        return None


def resolve_pointer(path: str) -> str:
    """Follow ``<path>.current`` if present; else ``path`` itself."""
    target = _read_pointer(path)
    if target is not None and os.path.exists(target):
        return target
    return path


def _fsync_write(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.save(f, arr, allow_pickle=False)
        f.flush()
        os.fsync(f.fileno())


def read_payload(path: str, mmap: bool = False
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """({leaf name: array}, {leaf name: dtype}) of one state dir (the
    pointer followed). bf16 leaves come back as their uint16 bits.
    ``mmap``: memory-mapped, read only where a caller touches them."""
    vdir = resolve_pointer(os.path.abspath(path))
    with open(os.path.join(vdir, DTYPES_FILE)) as f:
        dtypes = json.load(f)
    arrays = {name: np.load(os.path.join(vdir, name + ".npy"),
                            mmap_mode="r" if mmap else None,
                            allow_pickle=False) for name in dtypes}
    return arrays, dtypes


def payload_metadata(path: str) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{leaf name: (shape, dtype)} of one state dir, read from the .npy
    headers (no data read)."""
    arrays, dtypes = read_payload(path, mmap=True)
    return {name: (tuple(arrays[name].shape), dt)
            for name, dt in dtypes.items()}


class CheckpointEngine:
    """Writes a state tree (nested dicts of tensors and host ints) as one
    ``.npy`` per leaf into a versioned dir and publishes it by the
    ``.current`` pointer. ``async_save``: the write runs on a thread; the
    publish and ``on_complete`` wait for ``wait()`` (or the next save)."""

    def __init__(self, async_save: bool = False):
        self.async_save = async_save
        self._pending = None
        self._pinned: Dict[str, torch.Tensor] = {}

    def _host_copy(self, state) -> Dict[str, Tuple[np.ndarray, str]]:
        """Every leaf copied to host memory, complete when this returns.
        For an async save, CUDA leaves go into pinned buffers (kept for the
        next save) by non-blocking copies, then one event is waited on;
        otherwise every leaf is copied by a plain blocking copy. The
        copies are taken in stream order, before any later in-place update
        of the leaves."""
        out, pinned = {}, False
        for name, leaf in flatten(state).items():
            if not isinstance(leaf, torch.Tensor):
                arr = np.asarray(leaf)
                out[name] = (arr, str(arr.dtype))
                continue
            t = leaf.detach()
            if t.is_cuda and self.async_save:
                buf = self._pinned.get(name)
                if buf is None or buf.shape != t.shape \
                        or buf.dtype != t.dtype:
                    buf = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                    self._pinned[name] = buf
                buf.copy_(t, non_blocking=True)
                pinned = True
            else:
                buf = t.to("cpu", copy=True)
            out[name] = (buf, dtype_name(t.dtype))
        if pinned:
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        return {name: (to_numpy_bits(a) if isinstance(a, torch.Tensor) else a,
                       dt) for name, (a, dt) in out.items()}

    @staticmethod
    def _write(host: Dict[str, Tuple[np.ndarray, str]], vdir: str) -> None:
        os.makedirs(vdir)
        for name, (arr, _) in host.items():
            path = os.path.join(vdir, name + ".npy")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            _fsync_write(path, arr)
        integrity.atomic_write(
            os.path.join(vdir, DTYPES_FILE),
            json.dumps({n: dt for n, (_, dt) in host.items()}, indent=1),
            what="checkpoint dtype manifest write")

    def save(self, state, path: str,
             on_complete: Optional[Callable[[], None]] = None) -> None:
        if self._pending is not None:
            self.wait()            # finalize the previous in-flight save
        host = self._host_copy(state)
        path = os.path.abspath(path)
        prev = _read_pointer(path)
        token = f"{os.getpid()}-{int.from_bytes(os.urandom(4), 'big'):08x}"
        vdir = f"{path}-v{token}"
        if self.async_save:
            box: Dict[str, Exception] = {}

            def run():
                try:
                    self._write(host, vdir)
                except Exception as e:  # noqa: BLE001 - raised by wait()
                    box["error"] = e
            thread = threading.Thread(target=run, name="ckpt-writer",
                                      daemon=True)
            thread.start()
            self._pending = (thread, box, vdir, path, prev, on_complete)
            # the last save of a run must still land: finalize at exit if
            # nobody waited
            atexit.register(self.wait)
        else:
            self._pending = (None, {}, vdir, path, prev, on_complete)
            try:
                self._write(host, vdir)
            except BaseException:
                self._pending = None
                shutil.rmtree(vdir, ignore_errors=True)
                raise
            self.wait()

    def wait(self) -> None:
        """Join the in-flight write, then publish it: the pointer, the
        superseded version's removal, ``on_complete``. A failed write
        drops its partial version dir and is never published."""
        atexit.unregister(self.wait)
        pending, self._pending = self._pending, None
        if pending is None:
            return
        thread, box, vdir, path, prev, on_complete = pending
        if thread is not None:
            thread.join()
        if "error" in box:
            shutil.rmtree(vdir, ignore_errors=True)
            raise box["error"]
        integrity.atomic_write(_pointer_file(path), os.path.basename(vdir),
                               what="checkpoint pointer publish")
        if prev is not None and prev != vdir and os.path.exists(prev):
            shutil.rmtree(prev, ignore_errors=True)
        if on_complete is not None:
            on_complete()


def finalize_tag(save_dir: str, tag: str, *, save_latest: bool = True,
                 write_integrity: bool = True, checksums: bool = True,
                 keep_last_k: int = 0) -> None:
    """The integrity tail of every save: manifest -> COMMITTED -> latest ->
    retention, in that order. The commit marker is the tag's last file;
    its absence is the torn-save signal ``validate_tag`` keys on. `latest`
    is only a hint after this chain: a reader validates the tag it names
    and walks back when it lies."""
    ckpt_path = os.path.join(save_dir, str(tag))
    if write_integrity:
        integrity.write_manifest(ckpt_path, checksums=checksums)
        # corrupt_payload fault seam: bitrot AFTER the manifest hash
        rb_faults.mutate_seam(ckpt_path)
        # torn_save fault seam: a "crash" between payload and commit
        # marker, outside any retry (a torn save is a process death, not
        # a transient error)
        rb_faults.io_seam("ckpt_commit", ckpt_path)
        integrity.write_commit_marker(ckpt_path)
    if save_latest:
        integrity.atomic_write(os.path.join(save_dir, LATEST_FILE), str(tag),
                               what="checkpoint latest publish")
    if keep_last_k:
        # never prune the tag `latest` names: with save_latest=False it may
        # name an OLDER tag than the one just saved
        protect = {str(tag)}
        try:
            with open(os.path.join(save_dir, LATEST_FILE)) as f:
                protect.add(f.read().strip())
        except OSError:
            pass
        integrity.prune_tags(save_dir, keep_last_k, protect=protect)
    logger.info(f"saved checkpoint {ckpt_path}")


def save_checkpoint(save_dir: str, tag: str, state, *,
                    client_state: Optional[Dict[str, Any]] = None,
                    config_dict: Optional[Dict[str, Any]] = None,
                    engine: Optional[CheckpointEngine] = None,
                    save_latest: bool = True, write_integrity: bool = True,
                    checksums: bool = True, keep_last_k: int = 0) -> str:
    """save_dir/tag/{state-v*, state.current, meta.json}, then the
    integrity chain and save_dir/latest (``finalize_tag``). With an async
    ``engine`` this returns once the state is on the host; the rest runs
    at the engine's ``wait``."""
    engine = engine or CheckpointEngine()
    ckpt_path = os.path.join(save_dir, str(tag))
    rb_faults.io_seam("ckpt_save", ckpt_path)      # whole-save abort seam
    os.makedirs(ckpt_path, exist_ok=True)
    # overwriting a tag in place: drop its commit marker first so a crash
    # mid-overwrite reads as torn, never as the OLD save's marker vouching
    # for MIXED content; drop the stale manifest too when this save won't
    # write one
    integrity.invalidate(ckpt_path, drop_manifest=not write_integrity)

    def finalize():
        meta = {"schema": META_SCHEMA, "tag": str(tag),
                "client_state": client_state or {},
                "config": config_dict or {}, "world_size": 1,
                "framework_version": "deepspeed_tpu_torch-0.1"}
        integrity.atomic_write(os.path.join(ckpt_path, "meta.json"),
                               json.dumps(meta, indent=2, default=str),
                               what="checkpoint meta write")
        finalize_tag(save_dir, tag, save_latest=save_latest,
                     write_integrity=write_integrity, checksums=checksums,
                     keep_last_k=keep_last_k)

    engine.save(state, os.path.join(ckpt_path, "state"), on_complete=finalize)
    return ckpt_path


def resolve_load_tag(load_dir: str, tag: Optional[str] = None, *,
                     exclude: Iterable[str] = (),
                     deep: bool = True) -> Tuple[str, bool]:
    """Which tag to load: (tag, fell_back).

    An explicit tag is honoured verbatim. tag=None resolves `latest`,
    validates it against the integrity chain, and on a torn, corrupt,
    uncommitted or missing target walks back to the newest tag that still
    validates, emitting a ``ckpt_fallback`` event. Raises
    FileNotFoundError only when nothing under load_dir is loadable."""
    if tag is not None:
        return str(tag), False
    latest = os.path.join(load_dir, LATEST_FILE)
    requested = None
    if os.path.exists(latest):
        with open(latest) as f:
            requested = f.read().strip()
    if requested is not None and requested not in set(exclude):
        ok, reason = integrity.validate_tag(
            os.path.join(load_dir, requested), deep=deep)
        if ok:
            return requested, False
    elif requested is None:
        reason = f"no '{LATEST_FILE}' file"
    else:
        reason = "load failed"
    fallback = integrity.newest_valid_tag(
        load_dir, exclude=set(exclude) | ({requested} if requested else set()),
        deep=deep)
    if fallback is None:
        raise FileNotFoundError(
            f"no valid checkpoint under {load_dir} "
            f"(latest={requested!r}: {reason})")
    logger.warning(f"checkpoint fallback: latest={requested!r} is not "
                   f"loadable ({reason}); falling back to newest valid "
                   f"tag '{fallback}'")
    rb_events.emit("ckpt_fallback", dir=load_dir, requested=requested,
                   resolved=fallback, reason=reason)
    return fallback, True


def read_meta(ckpt_path: str) -> Dict[str, Any]:
    meta_path = os.path.join(ckpt_path, "meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def load_with_walk_back(load_dir: str, tag: Optional[str],
                        load_one: Callable[[str], Any]):
    """``load_one(tag)`` for an explicit tag (a failure there surfaces);
    for tag=None the resolved tag, walking back past any tag that
    validated but still failed to load (a shallow check, a bad payload),
    while one is left."""
    if tag is not None:
        return load_one(str(tag))
    tried = set()
    last_err = None
    while True:
        try:
            resolved, _ = resolve_load_tag(load_dir, None, exclude=tried)
        except FileNotFoundError:
            if last_err is not None:
                raise last_err
            raise
        try:
            return load_one(resolved)
        except Exception as e:  # noqa: BLE001 - any load failure walks back
            tried.add(resolved)
            last_err = e
            logger.warning(f"checkpoint tag '{resolved}' validated but "
                           f"failed to load ({e!r}); walking back")
            rb_events.emit("ckpt_fallback", dir=load_dir, requested=resolved,
                           resolved=None, reason=f"load-error: {e}")


def load_checkpoint(load_dir: str, tag: Optional[str] = None):
    """(flat arrays, dtypes, client_state) of one save; tag=None reads
    `latest`, validates it and walks back (``load_with_walk_back``)."""

    def load_one(t: str):
        ckpt_path = os.path.join(load_dir, t)
        arrays, dtypes = read_payload(os.path.join(ckpt_path, "state"))
        logger.info(f"loaded checkpoint {ckpt_path}")
        return arrays, dtypes, read_meta(ckpt_path).get("client_state", {})

    return load_with_walk_back(load_dir, tag, load_one)
