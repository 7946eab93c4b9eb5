"""File listing over source root paths, and deletes (counterpart of
hyperspace_tpu/io/files.py without its native walk).  Listing is
recursive; results are sorted by path for deterministic signatures.  A
root path may be a glob pattern (``expand_globs``), so an index whose
relation records a pattern covers directories that appear later.

Listings go through the ``io.list`` fault site and retry transient IO
errors (utils/retry.py); deletes of index data go through the
``io.delete`` site (io/faults.py)."""

from __future__ import annotations

import glob as _glob
import os
import shutil
from typing import List, Optional, Sequence

from hyperspace_tpu_torch.index.log_entry import FileInfo
from hyperspace_tpu_torch.io import faults
from hyperspace_tpu_torch.utils.paths import is_data_file, normalize_path
from hyperspace_tpu_torch.utils.retry import RetryPolicy

_GLOB_CHARS = ("*", "?", "[")


def list_dir(path: str, retry: Optional[RetryPolicy] = None) -> List[str]:
    """``os.listdir`` behind the ``io.list`` site with ``retry`` (the
    default policy if None): the listing primitive of log ids and index
    names.  A missing directory reads as empty."""
    def attempt() -> List[str]:
        faults.check("io.list")
        try:
            return os.listdir(path)
        except (FileNotFoundError, NotADirectoryError):
            return []

    return (retry if retry is not None else RetryPolicy()).call(attempt)


def remove_tree(path: str, ignore_errors: bool = False) -> None:
    """Delete a directory tree (vacuumed versions, spill run directories)
    behind the ``io.delete`` site."""
    faults.check("io.delete")
    shutil.rmtree(path, ignore_errors=ignore_errors)


def remove_file(path: str, missing_ok: bool = False) -> None:
    """Delete one file behind the ``io.delete`` site; with ``missing_ok``
    a missing file is no error."""
    faults.check("io.delete")
    try:
        os.unlink(path)
    except FileNotFoundError:
        if not missing_ok:
            raise


def expand_globs(root_paths: Sequence[str]) -> List[str]:
    """``root_paths`` with each glob pattern replaced by its sorted
    matches; a path that exists as it is, a directory named ``run[1]``
    say, reads as itself and is never a pattern."""
    out: List[str] = []
    for root in root_paths:
        if any(c in root for c in _GLOB_CHARS) and not os.path.exists(root):
            out.extend(sorted(_glob.glob(root)))
        else:
            out.append(root)
    return out


def list_data_files(root_paths: Sequence[str],
                    extension: Optional[str] = None) -> List[FileInfo]:
    """All data files under ``root_paths`` (each a file, a directory or a
    glob pattern of them), sorted by path; with ``extension``, only the
    files of a directory whose name ends with it.  The walk goes through
    the ``io.list`` site and retries transient errors with the default
    policy."""
    def attempt() -> List[FileInfo]:
        faults.check("io.list")
        return _list_data_files(root_paths, extension)

    return RetryPolicy().call(attempt)


def _list_data_files(root_paths: Sequence[str],
                     extension: Optional[str]) -> List[FileInfo]:
    out: List[FileInfo] = []
    for root in (normalize_path(r) for r in expand_globs(root_paths)):
        if os.path.isfile(root):
            out.append(_file_info(root))
        elif os.path.isdir(root):
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames.sort()
                for name in sorted(filenames):
                    if not is_data_file(name):
                        continue
                    if extension and not name.endswith(extension):
                        continue
                    out.append(_file_info(os.path.join(dirpath, name)))
    out.sort(key=lambda f: f.name)
    return out


def _file_info(path: str) -> FileInfo:
    st = os.stat(path)
    return FileInfo(path, st.st_size, int(st.st_mtime_ns))
