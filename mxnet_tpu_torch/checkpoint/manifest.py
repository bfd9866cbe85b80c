"""Checkpoint on-disk layout: atomic writes, JSON manifests, validation
(counterpart of ``mxnet_tpu/checkpoint/manifest.py``).

One committed checkpoint is one directory::

    <root>/step_0000000123/
        manifest.json             # index + sha256 content hashes + meta
        arrays/a00000.nd ...      # one reference-format .nd file per array
        blobs/trainer_states.bin  # opaque byte payloads (optimizer pickle)

The commit protocol makes a partial write invisible: everything is
written into ``step_0000000123.tmp-<pid>``, every file is fsync'd, the
manifest (which hashes every payload file) is written last, and a single
``os.replace`` renames the tmp dir onto the final name. A crash at ANY
point before the rename leaves only a ``*.tmp-*`` dir that readers
ignore and the next manager instance garbage-collects; a crash after the
rename leaves a fully-hashed, fully-fsync'd checkpoint.

The format is the JAX package's (``mxnet_tpu/checkpoint/manifest.py``),
so either package validates the other's directories; this copy is the
port's own. Besides the ``base`` error class it needs only the standard
library.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile

from ..base import MXNetError as _BaseError

MANIFEST_NAME = 'manifest.json'
FORMAT_VERSION = 1
STEP_DIR_RE = re.compile(r'^step_(\d{10})$')
TMP_SUFFIX_RE = re.compile(r'^step_\d{10}\.tmp-\d+$')
# a committed dir retired aside while a re-save of the same step swaps in
# (recoverable: if the swap died, the old copy is renamed back on startup)
OLD_DIR_RE = re.compile(r'^(step_\d{10})\.old-\d+$')
# a committed dir the scrubber (or a replica repair) moved aside after a
# hash mismatch: evidence for the post-mortem, never a restore target
QUARANTINE_DIR_RE = re.compile(r'^(step_(\d{10}))\.quarantine-\d+$')
# directory holding replicas this host stores on behalf of PEER ranks
# (one <REPLICA_SUBDIR>/<ns>/step_* tree per owner); dot-prefixed so
# committed_steps / the retention GC never confuse it with local steps
REPLICA_SUBDIR = '.replicas'


class CorruptCheckpointError(_BaseError):
    """A committed checkpoint failed manifest/hash validation."""


def step_dir_name(step: int) -> str:
    if step < 0:
        raise ValueError(f"checkpoint step must be >= 0, got {step}")
    return f'step_{int(step):010d}'


def parse_step(name: str):
    """Step number for a committed dir name, None for anything else."""
    m = STEP_DIR_RE.match(name)
    return int(m.group(1)) if m else None


def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def fsync_dir(path: str) -> None:
    """Durably record directory entries (renames/creates) themselves."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # e.g. platforms without dir fds
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes, durable: bool = True) -> None:
    """Write `data` to `path` so a crash never leaves a partial file: tmp
    file in the same directory (same filesystem), fsync, os.replace."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + '.tmp-',
                               dir=d)
    try:
        with os.fdopen(fd, 'wb') as f:
            f.write(data)
            if durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if durable:
        fsync_dir(d)


def write_bytes_durable(path: str, data: bytes) -> None:
    """Plain write + fsync, no tmp-file dance. For payload files inside
    an UNCOMMITTED checkpoint tmp dir: nothing there is visible until the
    directory-level os.replace commit, so per-file rename atomicity would
    be pure overhead (N renames + ~2N dir fsyncs per checkpoint); only
    durability before the commit rename matters."""
    with open(path, 'wb') as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def write_manifest(dirpath: str, doc: dict) -> None:
    doc = dict(doc)
    doc['format_version'] = FORMAT_VERSION
    atomic_write_bytes(os.path.join(dirpath, MANIFEST_NAME),
                       json.dumps(doc, indent=1, sort_keys=True)
                       .encode('utf-8'))


def read_manifest(dirpath: str) -> dict:
    path = os.path.join(dirpath, MANIFEST_NAME)
    try:
        with open(path, 'rb') as f:
            doc = json.loads(f.read().decode('utf-8'))
    except (OSError, ValueError, UnicodeDecodeError) as e:
        raise CorruptCheckpointError(
            f"checkpoint manifest {path} unreadable: {e}")
    if not isinstance(doc, dict) or \
            doc.get('format_version') != FORMAT_VERSION:
        raise CorruptCheckpointError(
            f"checkpoint manifest {path}: unknown format_version "
            f"{doc.get('format_version') if isinstance(doc, dict) else doc!r}")
    return doc


def scan_step_dir(dirpath: str, read_bytes=None):
    """Full integrity scan of one committed checkpoint dir.

    Re-hashes every payload file named by the manifest and checks byte
    counts. Returns ``(doc_or_None, [(kind, detail), ...])`` where
    ``kind`` classifies each problem as ``'missing'`` (a payload file
    the manifest names is absent) or ``'corrupt'`` (unreadable/
    malformed manifest, byte-count or content-hash mismatch) — the
    distinction the scrub CLI's exit codes report.

    ``read_bytes``: optional ``callable(path) -> bytes`` replacing the
    default streamed ``sha256_file`` — the ONE seam through which the
    background scrubber injects its ``checkpoint.read`` fault site and
    idle pacing, so there is exactly one integrity scanner over the
    manifest format. Exceptions it raises count as corrupt."""
    try:
        doc = read_manifest(dirpath)
    except CorruptCheckpointError as e:
        return None, [('corrupt', str(e))]
    problems = []
    entries = list(doc.get('arrays', [])) + list(doc.get('blobs', []))
    if not isinstance(doc.get('step'), int):
        problems.append(('corrupt', "manifest carries no integer 'step'"))
    for e in entries:
        rel = e.get('file')
        if not rel or '..' in rel.split('/'):
            problems.append(
                ('corrupt',
                 f"entry {e.get('name')!r}: bad file path {rel!r}"))
            continue
        path = os.path.join(dirpath, rel)
        if not os.path.isfile(path):
            problems.append(('missing', f"{rel}: missing"))
            continue
        if read_bytes is not None:
            try:
                data = read_bytes(path)
            except Exception as exc:  # read failure / injected fault
                problems.append(('corrupt', f"{rel}: {exc}"))
                continue
            size, digest = len(data), sha256_bytes(data)
        else:
            size, digest = os.path.getsize(path), None
        if size != e.get('bytes'):
            problems.append(
                ('corrupt',
                 f"{rel}: size {size} != manifest {e.get('bytes')}"))
            continue
        if digest is None:
            digest = sha256_file(path)
        if digest != e.get('sha256'):
            problems.append(
                ('corrupt',
                 f"{rel}: sha256 {digest[:12]}... != manifest "
                 f"{str(e.get('sha256'))[:12]}..."))
    return doc, problems


def validate_step_dir(dirpath: str):
    """Full integrity check of one committed checkpoint dir.

    Re-hashes every payload file named by the manifest and checks byte
    counts. Returns the parsed manifest; raises CorruptCheckpointError
    naming every problem found (all problems, not just the first, so the
    CLI tool's report is actionable)."""
    doc, problems = scan_step_dir(dirpath)
    if problems:
        raise CorruptCheckpointError(
            f"checkpoint {dirpath} corrupt: "
            + '; '.join(detail for _kind, detail in problems))
    return doc


def committed_steps(root: str):
    """Sorted ascending list of committed step numbers under `root`
    (tmp dirs and foreign names are ignored)."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    steps = []
    for n in names:
        s = parse_step(n)
        if s is not None and os.path.isdir(os.path.join(root, n)):
            steps.append(s)
    return sorted(steps)


def stale_tmp_dirs(root: str):
    """Leftover ``step_*.tmp-<pid>`` dirs from crashed/killed writers."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    return [os.path.join(root, n) for n in names if TMP_SUFFIX_RE.match(n)]


def quarantined_dirs(root: str):
    """[(path, step), ...] for ``step_*.quarantine-<pid>`` dirs — copies
    the scrubber (or a replica repair) retired after a hash mismatch.
    Kept as evidence until their step falls out of retention."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for n in names:
        m = QUARANTINE_DIR_RE.match(n)
        if m:
            out.append((os.path.join(root, n), int(m.group(2))))
    return out


def replica_namespaces(root: str):
    """Sorted owner namespaces (e.g. ``rank0``) with hosted replicas
    under ``<root>/.replicas``."""
    base = os.path.join(root, REPLICA_SUBDIR)
    try:
        names = os.listdir(base)
    except OSError:
        return []
    return sorted(n for n in names
                  if os.path.isdir(os.path.join(base, n)))


def stale_old_dirs(root: str):
    """[(old_path, final_path), ...] for ``step_*.old-<pid>`` dirs — a
    committed copy retired aside by a re-save of the same step. When the
    swap died before the new copy committed, `final_path` is missing and
    the old copy is the recovery source."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for n in names:
        m = OLD_DIR_RE.match(n)
        if m:
            out.append((os.path.join(root, n),
                        os.path.join(root, m.group(1))))
    return out
