"""Checkpoint integrity chain: per-tag manifest, commit marker, walk-back.
A copy of ``deepspeed_tpu/robustness/integrity.py`` (host only), with its
``ckpt_io`` fault-injection seam in ``atomic_write``.

Every committed tag carries:

  ``manifest.json``  — relpath -> {size, sha256} for every file in the tag
                       dir, written AFTER the payload is durable
  ``COMMITTED``      — a tiny marker written atomically LAST; its absence
                       means the save never finished (torn)

``validate_tag`` checks marker -> manifest -> sizes -> checksums, and
``newest_valid_tag`` walks tags newest-first so ``load_checkpoint(tag=None)``
can fall back past a corrupt or uncommitted ``latest`` to the newest save
that still verifies (emitting a ``ckpt_fallback`` event) instead of
raising. ``prune_tags`` bounds retention to the last K *good* tags:
invalid tags never count toward K (they are fallback evidence, not
capacity).

Tags with neither manifest nor marker but with a finished ``meta.json``
validate as ``legacy``: they cannot be judged, so the loader still tries
them.
"""

import hashlib
import json
import logging
import os
import shutil
import time
from typing import Dict, Iterable, List, Optional, Tuple

from deepspeed_tpu_torch.robustness.retry import retry_io

logger = logging.getLogger("deepspeed_tpu_torch")

MANIFEST_FILE = "manifest.json"
COMMIT_FILE = "COMMITTED"
_INTEGRITY_FILES = (MANIFEST_FILE, COMMIT_FILE)


def _tag_files(tag_dir: str) -> List[str]:
    """Relpaths of every payload file under the tag dir (integrity files and
    atomic-write temps excluded; temps are in flight, not payload)."""
    out = []
    for root, _dirs, files in os.walk(tag_dir):
        for fn in files:
            rel = os.path.relpath(os.path.join(root, fn), tag_dir)
            if rel in _INTEGRITY_FILES or ".tmp" in fn:
                continue
            out.append(rel)
    return sorted(out)


def file_digest(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def atomic_write(path: str, data: str, *, what: str) -> None:
    """The atomic small-file write of the checkpoint chain (tmp + fsync +
    rename), shared by the manifest, marker, meta, latest and pointer
    writers, each with the same bounded retry on transient errors and the
    same ``ckpt_io`` fault-injection seam."""
    from deepspeed_tpu_torch.robustness import faults as rb_faults

    def do():
        rb_faults.io_seam("ckpt_io", path)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    retry_io(do, what=what, path=path)


def _atomic_json(path: str, obj, *, what: str) -> None:
    atomic_write(path, json.dumps(obj, indent=1), what=what)


def write_manifest(tag_dir: str, *, checksums: bool = True) -> Dict:
    """Hash the tag dir's current payload into ``manifest.json``. Call only
    after the payload is durable (checkpoint finalize)."""
    entries = {}
    for rel in _tag_files(tag_dir):
        p = os.path.join(tag_dir, rel)
        entries[rel] = {"size": os.path.getsize(p),
                        "sha256": file_digest(p) if checksums else None}
    manifest = {"version": 1, "ts": time.time(), "files": entries}
    _atomic_json(os.path.join(tag_dir, MANIFEST_FILE), manifest,
                 what="checkpoint manifest write")
    return manifest


def write_commit_marker(tag_dir: str) -> None:
    """The atomic 'this save finished' bit, written LAST."""
    _atomic_json(os.path.join(tag_dir, COMMIT_FILE),
                 {"ts": time.time(), "tag": os.path.basename(tag_dir)},
                 what="checkpoint commit-marker write")


def invalidate(tag_dir: str, *, drop_manifest: bool = False) -> None:
    """Drop the commit marker before rewriting a tag in place, so a crash
    mid-overwrite reads as torn rather than silently mixing two saves.
    drop_manifest=True also removes the manifest: required when the NEW
    save will not write one (integrity disabled), otherwise the stale
    manifest would make the finished save validate as uncommitted forever
    instead of falling back to the legacy rescue."""
    names = (COMMIT_FILE, MANIFEST_FILE) if drop_manifest else (COMMIT_FILE,)
    for name in names:
        try:
            os.remove(os.path.join(tag_dir, name))
        except FileNotFoundError:
            pass


def is_committed(tag_dir: str) -> bool:
    return os.path.exists(os.path.join(tag_dir, COMMIT_FILE))


def validate_tag(tag_dir: str, *, deep: bool = True) -> Tuple[bool, str]:
    """(ok, reason). ``deep`` re-hashes content; shallow checks existence and
    sizes only (enough for truncation, not bitrot)."""
    if not os.path.isdir(tag_dir):
        return False, "missing"
    manifest_path = os.path.join(tag_dir, MANIFEST_FILE)
    if not is_committed(tag_dir):
        # saves without the chain have no manifest or marker but DID finish
        # (meta.json is written after the payload is durable): they can't
        # be judged, so the loader still tries them. A tag with neither
        # meta nor manifest is a torn in-progress save: skip it.
        if not os.path.exists(manifest_path) and os.path.exists(
                os.path.join(tag_dir, "meta.json")):
            return True, "legacy"
        return False, "uncommitted"
    try:
        with open(manifest_path) as f:
            files = json.load(f)["files"]
    except (OSError, ValueError, KeyError) as e:
        return False, f"manifest-unreadable: {e}"
    for rel, want in files.items():
        p = os.path.join(tag_dir, rel)
        if not os.path.exists(p):
            return False, f"missing-file: {rel}"
        if os.path.getsize(p) != want["size"]:
            return False, f"size-mismatch: {rel}"
        if deep and want.get("sha256") and file_digest(p) != want["sha256"]:
            return False, f"checksum-mismatch: {rel}"
    return True, "ok"


def _tag_mtime(tag_dir: str) -> float:
    """Recency key: the commit marker's mtime when present, else the
    manifest's, else the dir's."""
    for probe in (os.path.join(tag_dir, COMMIT_FILE),
                  os.path.join(tag_dir, MANIFEST_FILE), tag_dir):
        try:
            return os.path.getmtime(probe)
        except OSError:
            continue
    return 0.0


def list_tags(load_dir: str) -> List[str]:
    """Tag names under load_dir, newest first."""
    try:
        names = [n for n in os.listdir(load_dir)
                 if os.path.isdir(os.path.join(load_dir, n))]
    except OSError:
        return []
    return sorted(names, key=lambda n: _tag_mtime(os.path.join(load_dir, n)),
                  reverse=True)


def newest_valid_tag(load_dir: str, *, exclude: Iterable[str] = (),
                     deep: bool = True) -> Optional[str]:
    """Walk tags newest-first; return the first that validates."""
    excluded = set(exclude)
    for name in list_tags(load_dir):
        if name in excluded:
            continue
        ok, reason = validate_tag(os.path.join(load_dir, name), deep=deep)
        if ok:
            return name
        logger.warning(f"checkpoint integrity: skipping tag '{name}' "
                       f"({reason})")
    return None


def prune_tags(load_dir: str, keep_last_k: int,
               protect: Iterable[str] = ()) -> List[str]:
    """Delete committed-valid tags beyond the newest ``keep_last_k``.
    Invalid or uncommitted tags are left alone (they never count toward K
    and may still be wanted as post-mortem evidence); ``protect`` (e.g. the
    tag ``latest`` names) is never deleted. Returns the deleted tags."""
    if keep_last_k <= 0:
        return []
    protected = set(protect)
    good = [n for n in list_tags(load_dir)
            if validate_tag(os.path.join(load_dir, n), deep=False)[0]]
    deleted = []
    for name in good[keep_last_k:]:
        if name in protected:
            continue
        shutil.rmtree(os.path.join(load_dir, name), ignore_errors=True)
        deleted.append(name)
        logger.info(f"checkpoint retention: pruned tag '{name}' "
                    f"(keep_last_k={keep_last_k})")
    return deleted
