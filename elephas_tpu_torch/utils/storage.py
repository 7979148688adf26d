"""Remote object-store adapters for model saves and checkpoints.

A copy of ``elephas_tpu/utils/storage.py`` (standard library only),
without its binary object I/O (``read_bytes``/``write_bytes``, which
only the JAX package's KV spill tier calls). Object stores are the
cloud analog of the reference's ``hadoop fs`` put/get
(``elephas/spark_model.py:127-134``). A small scheme registry maps URL
prefixes to :class:`ObjectStore` implementations:

- ``gs://`` / ``s3://`` — shell out to the standard CLIs (``gsutil`` /
  ``aws s3``); a richer SDK store (google-cloud-storage, boto3) can be
  registered by the user.
- any scheme can be overridden via :func:`register_store` — tests (and
  air-gapped environments) register :class:`LocalMirrorStore`, which
  maps URLs onto a local directory with identical semantics.

Paths without a scheme (and ``file://``) bypass the registry entirely;
the hadoop-CLI path of :class:`~elephas_tpu_torch.tpu_model.TPUModel`
does not use it.
"""
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = ["ObjectStore", "CliObjectStore", "LocalMirrorStore",
           "register_store", "get_store", "split_scheme", "is_remote"]


def split_scheme(path: str) -> Tuple[Optional[str], str]:
    """``'gs://b/k' -> ('gs', 'b/k')``; plain paths -> ``(None, path)``."""
    path = str(path)
    if "://" in path:
        scheme, rest = path.split("://", 1)
        return scheme.lower(), rest
    return None, path


def is_remote(path: str) -> bool:
    scheme, _ = split_scheme(path)
    return scheme is not None and scheme != "file"


class ObjectStore:
    """Minimal object-store interface the framework needs."""

    def put_file(self, local: str, url: str):
        raise NotImplementedError

    def get_file(self, url: str, local: str):
        raise NotImplementedError

    def exists(self, url: str) -> bool:
        raise NotImplementedError

    def delete(self, url: str, recursive: bool = False):
        raise NotImplementedError

    def put_dir(self, local_dir: str, url: str):
        local_dir = Path(local_dir)
        for p in sorted(local_dir.rglob("*")):
            if p.is_file():
                rel = p.relative_to(local_dir).as_posix()
                self.put_file(str(p), f"{url.rstrip('/')}/{rel}")

    def get_dir(self, url: str, local_dir: str):
        raise NotImplementedError

    def read_text(self, url: str) -> str:
        raise NotImplementedError

    def write_text(self, url: str, text: str):
        raise NotImplementedError


class CliObjectStore(ObjectStore):
    """Object store backed by a copy CLI (``gsutil`` / ``aws s3``).

    Commands are built per scheme; any failure surfaces the CLI's stderr
    so misconfigured credentials are debuggable rather than swallowed.
    """

    _CLIS = {
        # dir copies use rsync/sync (not cp -r): idempotent re-saves
        # must not nest the source under an existing destination, and
        # both CLIs then agree on contents-into-destination semantics
        "gs": {"cp": ["gsutil", "-q", "cp"],
               "sync": ["gsutil", "-q", "-m", "rsync", "-r"],
               "stat": ["gsutil", "-q", "stat"],
               "ls": ["gsutil", "-q", "ls"],
               "rm": ["gsutil", "-q", "rm"],
               "rm_r": ["gsutil", "-q", "rm", "-r"],
               "cat": ["gsutil", "-q", "cat"]},
        "s3": {"cp": ["aws", "s3", "cp", "--only-show-errors"],
               "sync": ["aws", "s3", "sync", "--only-show-errors"],
               "rm": ["aws", "s3", "rm", "--only-show-errors"],
               "rm_r": ["aws", "s3", "rm", "--recursive",
                        "--only-show-errors"],
               "cat": ["aws", "s3", "cp", "--only-show-errors"]},
    }

    def __init__(self, scheme: str):
        if scheme not in self._CLIS:
            raise ValueError(f"no CLI mapping for scheme {scheme!r}")
        self.scheme = scheme
        self._cli = self._CLIS[scheme]

    def _run(self, argv: List[str], check: bool = True):
        proc = subprocess.run(argv, capture_output=True, text=True)
        if check and proc.returncode != 0:
            raise RuntimeError(
                f"{argv[0]} failed ({' '.join(argv)}): "
                f"{proc.stderr.strip() or proc.stdout.strip()}")
        return proc

    def put_file(self, local: str, url: str):
        self._run(self._cli["cp"] + [str(local), url])

    def get_file(self, url: str, local: str):
        self._run(self._cli["cp"] + [url, str(local)])

    def exists(self, url: str) -> bool:
        # exact-object checks: 'ls'-style listing prefix-matches sibling
        # keys (model.h5 vs model.h5.bak), so gs uses stat and s3 uses
        # s3api head-object on the split bucket/key
        if self.scheme == "s3":
            _, rest = split_scheme(url)
            bucket, _, key = rest.partition("/")
            proc = self._run(["aws", "s3api", "head-object", "--bucket",
                              bucket, "--key", key], check=False)
            return proc.returncode == 0
        return self._run(self._cli["stat"] + [url],
                         check=False).returncode == 0

    def delete(self, url: str, recursive: bool = False):
        key = "rm_r" if recursive else "rm"
        argv = self._cli[key] + ([url.rstrip("/") + "/"]
                                 if recursive and self.scheme == "s3"
                                 else [url])
        self._run(argv, check=False)

    def put_dir(self, local_dir: str, url: str):
        # one recursive sync instead of per-file round trips
        self._run(self._cli["sync"] + [str(local_dir), url])

    def get_dir(self, url: str, local_dir: str):
        Path(local_dir).mkdir(parents=True, exist_ok=True)
        self._run(self._cli["sync"] + [url, str(local_dir)])

    def read_text(self, url: str) -> str:
        if self.scheme == "s3":  # aws has no cat; copy through stdout
            proc = self._run(self._cli["cat"] + [url, "-"])
        else:
            proc = self._run(self._cli["cat"] + [url])
        return proc.stdout

    def write_text(self, url: str, text: str):
        import tempfile

        with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                         delete=False) as f:
            f.write(text)
            tmp = f.name
        try:
            self.put_file(tmp, url)
        finally:
            Path(tmp).unlink(missing_ok=True)


class LocalMirrorStore(ObjectStore):
    """Local-directory fake with object-store semantics: ``gs://b/k``
    maps to ``<root>/b/k``. The test double for the remote paths, and a
    practical store for shared-filesystem 'remotes'."""

    def __init__(self, root: str):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, url: str) -> Path:
        _, rest = split_scheme(url)
        return self.root / rest

    def put_file(self, local: str, url: str):
        dest = self._path(url)
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(local, dest)

    def get_file(self, url: str, local: str):
        Path(local).parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(self._path(url), local)

    def exists(self, url: str) -> bool:
        return self._path(url).exists()

    def delete(self, url: str, recursive: bool = False):
        path = self._path(url)
        if path.is_dir() and recursive:
            shutil.rmtree(path, ignore_errors=True)
        elif path.exists():
            path.unlink()

    def get_dir(self, url: str, local_dir: str):
        src = self._path(url)
        shutil.copytree(src, local_dir, dirs_exist_ok=True)

    def read_text(self, url: str) -> str:
        return self._path(url).read_text()

    def write_text(self, url: str, text: str):
        dest = self._path(url)
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text(text)


_REGISTRY: Dict[str, ObjectStore] = {}


def register_store(scheme: str, store: Optional[ObjectStore]):
    """Install (or with ``None``, remove) the store handling ``scheme``."""
    if store is None:
        _REGISTRY.pop(scheme, None)
    else:
        _REGISTRY[scheme] = store


def get_store(url: str) -> ObjectStore:
    """The store for ``url``'s scheme; registered stores win, then the
    CLI-backed defaults for gs/s3."""
    scheme, _ = split_scheme(url)
    if scheme is None or scheme == "file":
        raise ValueError(f"{url!r} is a local path, not an object-store URL")
    store = _REGISTRY.get(scheme)
    if store is not None:
        return store
    return CliObjectStore(scheme)
