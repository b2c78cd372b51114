"""The port's small utilities against the JAX package's on the CPU: the
metrics, the cache, download and archive helpers (local files only: a
``file://`` URL and archives made under ``tmp_path``), the dataset base
classes on a local raw directory, ``torch_utils`` (the counterpart of
``jax_utils``) and the profiling helpers that run without a card."""
import os
import shutil
import tarfile
import zipfile
from pathlib import Path
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_geometric_tpu.data import dataset as jdataset
from tf_geometric_tpu.utils import data_utils as jdata_utils
from tf_geometric_tpu.utils import jax_utils
from tf_geometric_tpu.utils import metrics as jmetrics
from tf_geometric_tpu_torch.data import dataset as tdataset
from tf_geometric_tpu_torch.utils import data_utils, metrics, profiling, torch_utils


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_accuracy_and_masked_accuracy_match_jax():
    rng = np.random.default_rng(0)
    preds, labels = rng.integers(0, 4, 200), rng.integers(0, 4, 200)
    mask = rng.random(200) < 0.3
    got = metrics.accuracy(torch.as_tensor(preds), torch.as_tensor(labels))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert float(got) == pytest.approx(float(jmetrics.accuracy(preds, labels)), abs=1e-7)
    for m in (mask, mask.astype(np.float32), np.zeros(200, bool)):
        got = metrics.masked_accuracy(torch.as_tensor(preds), labels, torch.as_tensor(m))
        assert float(got) == pytest.approx(float(jmetrics.masked_accuracy(preds, labels, m)),
                                           abs=1e-7)


def test_micro_f1_matches_jax():
    rng = np.random.default_rng(1)
    preds, labels = rng.random((50, 6)) < 0.4, rng.random((50, 6)) < 0.3
    assert metrics.micro_f1(torch.as_tensor(preds), labels) == jmetrics.micro_f1(preds, labels)
    zeros = np.zeros((3, 2), bool)
    assert metrics.micro_f1(zeros, zeros) == jmetrics.micro_f1(zeros, zeros) == 0.0


@pytest.mark.parametrize("case", ["ties", "continuous", "one_class"])
def test_binary_auc_matches_jax_and_sklearn(case):
    from sklearn.metrics import roc_auc_score
    rng = np.random.default_rng(2)
    labels = rng.random(400) < 0.4
    scores = (rng.integers(0, 6, 400) / 5.0 if case == "ties"
              else rng.normal(size=400) + labels)
    if case == "one_class":
        labels = np.ones(400, bool)
    got = metrics.binary_auc(torch.as_tensor(scores), labels)
    assert got == jmetrics.binary_auc(scores, labels)
    if case != "one_class":
        assert got == pytest.approx(roc_auc_score(labels, scores), abs=1e-12)
    else:
        assert got == 0.5


def test_accumulator_matches_jax():
    got, want = metrics.Accumulator(), jmetrics.Accumulator()
    assert got.result() == want.result() == 0.0
    for value, weight in ((0.5, 2), (torch.tensor(1.0), 1), (0.25, 3.5)):
        got.update(value, weight)
        want.update(float(value), weight)
    assert got.result() == want.result()
    got.reset()
    assert got.result() == 0.0 and got.weight == 0.0


# ---------------------------------------------------------------------------
# cache, download and archive helpers
# ---------------------------------------------------------------------------

def test_cache_round_trip_and_missing_file(tmp_path):
    obj = {"x": np.arange(5), "y": [1, 2.5, "a"]}
    path = str(tmp_path / "sub" / "cache.p")
    assert data_utils.load_cache(path) is None
    data_utils.save_cache(obj, path)
    for loaded in (data_utils.load_cache(path), jdata_utils.load_cache(path)):
        np.testing.assert_array_equal(loaded["x"], obj["x"])
        assert loaded["y"] == obj["y"]


def test_download_file_from_a_local_url_with_failover(tmp_path):
    src = tmp_path / "served.bin"
    src.write_bytes(b"payload" * 100)
    target = str(tmp_path / "dl" / "file.bin")
    missing = (tmp_path / "missing.bin").as_uri()
    assert data_utils.download_file(target, [missing, src.as_uri()], verbose=False) == target
    assert open(target, "rb").read() == src.read_bytes()
    assert not os.path.exists(target + ".part")
    src.write_bytes(b"changed")  # an existing file is not fetched again
    assert data_utils.download_file(target, src.as_uri(), verbose=False) == target
    assert open(target, "rb").read() == b"payload" * 100


def test_download_file_raises_when_every_url_fails(tmp_path):
    with pytest.raises(RuntimeError, match="failed to download"):
        data_utils.download_file(str(tmp_path / "x.bin"),
                                 [(tmp_path / "a").as_uri(), "not a url"], verbose=False)


@pytest.mark.parametrize("kind", ["zip", "tar", "gztar"])
def test_extract_archive(tmp_path, kind):
    content = tmp_path / "content"
    (content / "inner").mkdir(parents=True)
    (content / "a.txt").write_text("A")
    (content / "inner" / "b.txt").write_text("B")
    archive = shutil.make_archive(str(tmp_path / "pack"), kind, root_dir=content)
    for fn, out in ((data_utils.extract_archive, "port"),
                    (jdata_utils.extract_archive, "jax")):
        fn(archive, str(tmp_path / out))
        assert (tmp_path / out / "a.txt").read_text() == "A"
        assert (tmp_path / out / "inner" / "b.txt").read_text() == "B"
    assert zipfile.is_zipfile(archive) == (kind == "zip")
    assert tarfile.is_tarfile(archive) == (kind != "zip")


# ---------------------------------------------------------------------------
# datasets on a local raw directory
# ---------------------------------------------------------------------------

def _dataset_classes():
    def make(base):
        class EdgeListDataset(base):
            """Reads ``raw/edges.txt`` (a pair per line) into an edge array."""

            processed = 0

            def process(self):
                type(self).processed += 1
                return np.loadtxt(os.path.join(self.raw_root_path, "edges.txt"), np.int64)
        return EdgeListDataset
    return make(tdataset.DownloadableDataset), make(jdataset.DownloadableDataset)


def test_dataset_root_and_directories_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("TFG_TPU_DATA_ROOT", str(tmp_path))
    assert tdataset.default_dataset_root() == jdataset.default_dataset_root() == str(tmp_path)
    monkeypatch.delenv("TFG_TPU_DATA_ROOT")
    assert tdataset.default_dataset_root() == jdataset.default_dataset_root()
    got = tdataset.DownloadableDataset("cora", download_urls=["file:///x/cora.zip"])
    want = jdataset.DownloadableDataset("cora", download_urls=["file:///x/cora.zip"])
    for attr in ("dataset_root_path", "download_root_path", "raw_root_path",
                 "processed_root_path", "download_path", "download_file_name"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.cache_path == os.path.join(want.processed_root_path, "cache_torch.p")
    assert want.cache_path == os.path.join(want.processed_root_path, "cache.p")
    assert tdataset.DownloadableDataset("x", cache_name=None).cache_path is None
    with pytest.raises(NotImplementedError):
        tdataset.Dataset().load_data()


def test_dataset_reads_local_raw_files_and_keeps_its_own_cache(tmp_path, monkeypatch):
    """Both packages read the same raw file; the port caches under its own
    name (a JAX cache beside it is never unpickled), and a second load
    reads the cache without processing again."""
    monkeypatch.setenv("TFG_TPU_DATA_ROOT", str(tmp_path))
    PortSet, JaxSet = _dataset_classes()
    raw = tmp_path / "toy" / "raw"
    raw.mkdir(parents=True)
    (raw / "edges.txt").write_text("0 1\n1 2\n2 0\n")
    want = JaxSet("toy").load_data()
    got = PortSet("toy").load_data()
    np.testing.assert_array_equal(got, want)
    processed = sorted(os.listdir(tmp_path / "toy" / "processed"))
    assert processed == ["cache.p", "cache_torch.p"]
    (raw / "edges.txt").write_text("5 5\n")
    np.testing.assert_array_equal(PortSet("toy").load_data(), want)
    assert PortSet.processed == 1


@pytest.mark.parametrize("archived", [True, False])
def test_dataset_downloads_and_extracts_a_local_file(tmp_path, archived):
    """With no raw directory: fetch from a ``file://`` URL, unpack an
    archive (or copy a plain file) into ``raw/``, then process."""
    served = tmp_path / "served"
    served.mkdir()
    (served / "edges.txt").write_text("3 4\n4 5\n")
    url = (served / "edges.txt").as_uri()
    if archived:
        url = Path(shutil.make_archive(str(tmp_path / "toy"), "zip", root_dir=served)).as_uri()
    PortSet, _ = _dataset_classes()
    ds = PortSet("toy", download_urls=[url], dataset_root_path=str(tmp_path / "root"))
    np.testing.assert_array_equal(ds.load_data(), [[3, 4], [4, 5]])
    assert os.path.exists(ds.download_path) and os.path.exists(ds.cache_path)


# ---------------------------------------------------------------------------
# torch_utils (jax_utils' counterparts)
# ---------------------------------------------------------------------------

def test_function_returns_the_function_and_refuses_unknown_keywords():
    def f(x, training=False):
        return x * (2 if training else 1)

    assert torch_utils.function(f) is f
    assert torch_utils.function(static_argnums=(1,))(f) is f
    assert torch_utils.function(static_argnames=("training",))(f)(3, training=True) == 6
    assert jax_utils.function(f)(3, training=True) == 6  # JAX's: training made static
    with pytest.raises(TypeError):
        torch_utils.function(donate_argnums=(0,))


class _Pair(NamedTuple):
    a: object
    b: object


def _tree(kind):
    conv = torch.as_tensor if kind == "torch" else np.asarray
    return {"w": conv(np.arange(6, dtype=np.float32).reshape(2, 3)),
            "idx": conv(np.arange(4, dtype=np.int32)),
            "layers": [(conv(np.ones(2, np.float32)), 3), None,
                       _Pair(conv(np.zeros(3, np.float64)), conv(np.array([1, 2])))],
            "a_scale": 0.5}


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_split_hybrid_constants_matches_jax(kind):
    """The float leaves in JAX's pytree order (dict keys sorted), and a
    rebuild that gives the structure back with new values."""
    tree = _tree(kind)
    vals, rebuild = torch_utils.split_hybrid_constants(tree)
    jvals, jrebuild = jax_utils.split_hybrid_constants(_tree("numpy"))
    assert len(vals) == len(jvals) == 3
    for got, want in zip(vals, jvals):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    doubled = rebuild([v * 2 for v in vals])
    jdoubled = jrebuild([jnp.asarray(v) * 2 for v in jvals])
    assert list(doubled) == sorted(tree) == list(jdoubled)
    np.testing.assert_array_equal(np.asarray(doubled["w"]), np.asarray(jdoubled["w"]))
    assert doubled["idx"] is tree["idx"] and doubled["a_scale"] == 0.5
    assert doubled["layers"][1] is None and doubled["layers"][0][1] == 3
    assert isinstance(doubled["layers"][2], _Pair) and isinstance(doubled["layers"][0], tuple)
    np.testing.assert_array_equal(np.asarray(doubled["layers"][2].a), np.zeros(3))
    assert doubled["layers"][2].b is tree["layers"][2].b


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path)) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert log_dir == str(tmp_path)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1 and os.path.getsize(tmp_path / files[0]) > 0


def test_measure_step_time_takes_jax_arguments_and_needs_a_card():
    import inspect
    from tf_geometric_tpu.utils import profiling as jprofiling
    params = inspect.signature(profiling.measure_step_time).parameters
    jparams = inspect.signature(jprofiling.measure_step_time).parameters
    assert [(p.name, p.default) for p in params.values()] == [
        (p.name, p.default) for p in jparams.values()]
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.measure_step_time(lambda h: (h,), (torch.ones(2),), lo=1, hi=2)
