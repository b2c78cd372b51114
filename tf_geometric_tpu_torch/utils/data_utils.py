"""Download, archive and pickle-cache helpers (JAX counterpart:
``tf_geometric_tpu/utils/data_utils.py``)."""
from __future__ import annotations

import os
import pickle
import shutil
import urllib.request

__all__ = ["download_file", "save_cache", "load_cache", "extract_archive"]

_DOWNLOAD_TIMEOUT_S = 60


def download_file(path: str, urls, verbose: bool = True) -> str:
    """``path``, fetched from the first of ``urls`` that works unless it
    exists already (written to ``path + ".part"``, then renamed). Raises
    ``RuntimeError`` when every URL fails: where there is no network, place
    the file under the dataset's raw directory instead."""
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if isinstance(urls, str):
        urls = [urls]
    last_err = None
    for url in urls:
        try:
            if verbose:
                print(f"downloading {url} -> {path}")
            tmp = path + ".part"
            with urllib.request.urlopen(url, timeout=_DOWNLOAD_TIMEOUT_S) as r, \
                    open(tmp, "wb") as f:
                shutil.copyfileobj(r, f)
            os.replace(tmp, path)
            return path
        except (OSError, ValueError) as e:  # unreachable or malformed: try the next URL
            last_err = e
    raise RuntimeError(f"failed to download {path} from {urls}: {last_err}")


def extract_archive(archive_path: str, target_dir: str) -> None:
    """Unpack a zip or tar archive into ``target_dir``."""
    os.makedirs(target_dir, exist_ok=True)
    shutil.unpack_archive(archive_path, target_dir)


def save_cache(obj, path: str) -> None:
    """Pickle ``obj`` to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_cache(path: str):
    """The object pickled at ``path`` by ``save_cache``, or None if there is
    no file. Only for files this package wrote: unpickling runs code."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)
