"""Dataset base classes (JAX counterpart: ``tf_geometric_tpu/data/dataset.py``).

Pipeline: download, extract, ``process()``, then a pickle cache, under
``<root>/<name>/{download,raw,processed}``, the same directories as the JAX
package (``default_dataset_root``: ``TFG_TPU_DATA_ROOT`` or
``~/.tfg_tpu_datasets``), so both read the same raw files. Where there is no
network, place the raw files under ``raw_root_path`` and the pipeline picks
them up.

The cache is the port's own: the JAX package pickles its processed graphs
to ``processed/<cache_name>`` and unpickling them would import the JAX
package, so the port writes and reads ``processed/<stem>_torch<ext>``
(``cache.p`` → ``cache_torch.p``).
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

from ..utils.data_utils import download_file, extract_archive, load_cache, save_cache

__all__ = ["Dataset", "DownloadableDataset", "default_dataset_root", "port_cache_name"]

_ARCHIVE_EXTS = (".zip", ".tar", ".tar.gz", ".tgz")


def default_dataset_root() -> str:
    return os.environ.get("TFG_TPU_DATA_ROOT",
                          os.path.join(os.path.expanduser("~"), ".tfg_tpu_datasets"))


def port_cache_name(cache_name: str) -> str:
    """The file name the port caches under in place of the JAX package's
    ``cache_name``."""
    stem, ext = os.path.splitext(cache_name)
    return f"{stem}_torch{ext}"


class Dataset:
    """Abstract dataset: subclasses implement ``process()``."""

    def process(self):
        raise NotImplementedError

    def load_data(self):
        return self.process()


class DownloadableDataset(Dataset):
    """Download, extract, process and cache (``cache_name=None``: no cache)."""

    def __init__(self, dataset_name: str, download_urls=None,
                 download_file_name: Optional[str] = None,
                 cache_name: Optional[str] = "cache.p",
                 dataset_root_path: Optional[str] = None):
        self.dataset_name = dataset_name
        self.download_urls = download_urls
        self.download_file_name = download_file_name or (
            None if download_urls is None else os.path.basename(str(download_urls[0])))
        self.cache_name = cache_name
        if dataset_root_path is None:
            dataset_root_path = os.path.join(default_dataset_root(), dataset_name)
        self.dataset_root_path = dataset_root_path
        self.download_root_path = os.path.join(dataset_root_path, "download")
        self.raw_root_path = os.path.join(dataset_root_path, "raw")
        self.processed_root_path = os.path.join(dataset_root_path, "processed")

    @property
    def cache_path(self) -> Optional[str]:
        if self.cache_name is None:
            return None
        return os.path.join(self.processed_root_path, port_cache_name(self.cache_name))

    @property
    def download_path(self) -> Optional[str]:
        if self.download_file_name is None:
            return None
        return os.path.join(self.download_root_path, self.download_file_name)

    def download(self):
        if self.download_urls is None:
            return
        download_file(self.download_path, self.download_urls)

    def extract(self):
        """Unpack an archive into the raw directory, or copy a plain file there."""
        path = self.download_path
        if path is None or not os.path.exists(path):
            return
        if path.endswith(_ARCHIVE_EXTS):
            extract_archive(path, self.raw_root_path)
        else:
            os.makedirs(self.raw_root_path, exist_ok=True)
            target = os.path.join(self.raw_root_path, os.path.basename(path))
            if not os.path.exists(target):
                shutil.copy(path, target)

    def load_data(self):
        """The cached result if there is one; else download and extract when
        the raw directory is missing or empty, process, and cache."""
        cache_path = self.cache_path
        if cache_path is not None:
            cached = load_cache(cache_path)
            if cached is not None:
                return cached
        if not os.path.exists(self.raw_root_path) or not os.listdir(self.raw_root_path):
            self.download()
            self.extract()
        data = self.process()
        if cache_path is not None:
            save_cache(data, cache_path)
        return data
