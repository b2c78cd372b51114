"""The port's datasets against the JAX package's on the CPU, bit for bit
(same dtype, shape and values).

Synthetic sets: the same seed on both sides (the citation graphs at the
Cora, Citeseer and Pubmed shapes, ``HardCitationDataset`` for each
``_MODEL_DIFFICULTY`` key, ``flip_graph_labels``, the DropGNN testbeds).
The DropGNN sets draw from unseeded generators (``default_rng()`` and
networkx's global ``random``), so the tests seed both the same way on each
side. The arxiv-shaped hard set (169,343 nodes) is left out for its size:
it runs the same code as the other shapes.

File loaders: tiny files in each upstream format under ``tmp_path``, read
by both packages' loaders (the writers of ``tests/test_datasets.py`` and
``tests/test_datasets_fixtures.py`` by import where they exist).
"""
import json
import os
import random
import shutil

import numpy as np
import pytest
import scipy.sparse as sp

import tf_geometric_tpu.datasets as jds
import tf_geometric_tpu.datasets.synthetic as jsyn
import tf_geometric_tpu.datasets.synthetic_citation as jsc
import tf_geometric_tpu_torch.datasets as tds
import tf_geometric_tpu_torch.datasets.synthetic as tsyn
import tf_geometric_tpu_torch.datasets.synthetic_citation as tsc
from tests.test_datasets import _write_planetoid_fixture, _write_tu_fixture
from tests.test_datasets_fixtures import (_OFF_QUAD, _OFF_TETRA, _write_hgb_acm_fixture,
                                          _write_reddit_fixture)

SEEDS = (0, 3)
SHAPES = ("cora", "citeseer", "pubmed")


def assert_same_array(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=name)


def assert_same_graph(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in ("x", "edge_index", "edge_weight", "y"):
        assert_same_array(getattr(got, f), getattr(want, f), f)


def assert_same_splits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g) is type(w)
        assert_same_array(g, w)


@pytest.mark.parametrize("seed", SEEDS)
def test_synthetic_citation_graph_with_overlap(seed):
    kwargs = dict(num_nodes=400, num_features=90, num_classes=5, avg_degree=5.0,
                  homophily=0.6, feature_signal=1.5, class_overlap=0.4, seed=seed)
    assert_same_graph(tsc.synthetic_citation_graph(**kwargs),
                      jsc.synthetic_citation_graph(**kwargs))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", SHAPES)
def test_fake_planetoid_matches_jax(name, seed):
    got_graph, got_splits = tsc.FakePlanetoidDataset(name, seed=seed).load_data()
    want_graph, want_splits = jsc.FakePlanetoidDataset(name, seed=seed).load_data()
    assert_same_graph(got_graph, want_graph)
    assert_same_splits(got_splits, want_splits)


HARD_KEYS = [(None, name) for name in SHAPES] + sorted(jsc.HardCitationDataset._MODEL_DIFFICULTY,
                                                      key=str)


def test_hard_tables_match_jax():
    for table in ("_SHAPES", "_DIFFICULTY", "_VAL_SIZE", "_TEST_SIZE", "_MODEL_DIFFICULTY"):
        assert getattr(tsc.HardCitationDataset, table) == getattr(jsc.HardCitationDataset, table)
    assert tsc.HardCitationDataset.TRAIN_PER_CLASS == jsc.HardCitationDataset.TRAIN_PER_CLASS
    assert tsc.HardCitationDataset.LABEL_NOISE == jsc.HardCitationDataset.LABEL_NOISE


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("model,name", HARD_KEYS)
def test_hard_citation_matches_jax(model, name, seed, monkeypatch):
    monkeypatch.delenv("TFG_HARD_MODEL", raising=False)
    got_graph, got_splits = tsc.HardCitationDataset(name, seed=seed, model=model).load_data()
    want_graph, want_splits = jsc.HardCitationDataset(name, seed=seed, model=model).load_data()
    assert_same_graph(got_graph, want_graph)
    assert_same_splits(got_splits, want_splits)


def test_hard_citation_reads_model_from_environment(monkeypatch):
    """``model=None`` reads ``TFG_HARD_MODEL`` on both sides; the override
    changes the graph."""
    monkeypatch.setenv("TFG_HARD_MODEL", "gat")
    got = tsc.HardCitationDataset("citeseer", seed=1)
    want = jsc.HardCitationDataset("citeseer", seed=1)
    assert got.model == want.model == "gat"
    got_graph, got_splits = got.load_data()
    want_graph, want_splits = want.load_data()
    assert_same_graph(got_graph, want_graph)
    assert_same_splits(got_splits, want_splits)
    assert len(got_splits[0]) == 20 * 6  # the (gat, citeseer) train_per_class


@pytest.mark.parametrize("seed", SEEDS)
def test_flip_graph_labels_matches_jax(seed):
    got_graphs, _ = tsc.synthetic_graph_classification_hard(num_graphs=40, seed=seed)
    want_graphs, _ = jsc.synthetic_graph_classification_hard(num_graphs=40, seed=seed)
    got = tsc.flip_graph_labels(got_graphs[:30], noise=0.2, seed=seed + 42)
    want = jsc.flip_graph_labels(want_graphs[:30], noise=0.2, seed=seed + 42)
    assert len(got) == len(want) == 30
    for g, w in zip(got, want):
        assert_same_array(g.y, w.y)
    flipped = [int(np.asarray(g.y)[0]) != int(np.asarray(o.y)[0])
               for g, o in zip(got, tsc.synthetic_graph_classification_hard(40, seed=seed)[0])]
    assert sum(flipped) == 6


@pytest.fixture
def seeded_entropy(monkeypatch):
    """Make the DropGNN sets' unseeded draws repeatable: ``default_rng()``
    takes its seeds from a counter and networkx's global ``random`` is
    seeded; call the returned function before each side."""
    real = np.random.default_rng
    counter = {"n": 0}

    def default_rng(seed=None):
        if seed is None:
            counter["n"] += 1
            seed = 1000 + counter["n"]
        return real(seed)

    monkeypatch.setattr(np.random, "default_rng", default_rng)

    def reset():
        counter["n"] = 0
        random.seed(0)

    return reset


@pytest.mark.parametrize("name", ["LimitsOneDataset", "LimitsTwoDataset"])
def test_limits_datasets_match_jax(name, seeded_entropy):
    seeded_entropy()
    got = getattr(tsyn, name)().load_data()
    seeded_entropy()
    want = getattr(jsyn, name)().load_data()
    for g, w, field in zip(got, want, ("x", "edge_index", "y", "node_ids", "ports")):
        assert_same_array(g, w, field)
    for attr in ("hidden_units", "num_classes", "num_features", "num_nodes", "graph_class"):
        assert getattr(getattr(tsyn, name)(), attr) == getattr(getattr(jsyn, name)(), attr)


@pytest.mark.parametrize("seed", SEEDS)
def test_ports_and_ids_match_jax(seed):
    ei = np.array([[0, 1, 1, 2, 2, 0, 3, 0], [1, 0, 2, 1, 0, 2, 0, 3]])
    assert_same_array(tsyn._create_ports(ei, 4, seed), jsyn._create_ports(ei, 4, seed))
    assert_same_array(tsyn._create_id(9, seed), jsyn._create_id(9, seed))


def test_lcc_dataset_matches_jax(seeded_entropy):
    pytest.importorskip("networkx")
    seeded_entropy()
    got = tsyn.LCCDataset().load_data()
    seeded_entropy()
    want = jsyn.LCCDataset().load_data()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            assert_same_array(g[k], w[k], k)


def test_triangles_dataset_matches_jax(seeded_entropy):
    pytest.importorskip("networkx")
    seeded_entropy()
    got = tsyn.TrianglesDataset().load_data()
    seeded_entropy()
    want = jsyn.TrianglesDataset().load_data()
    for g, w, field in zip(got, want, ("x", "edge_index", "y", "node_ids", "ports")):
        assert_same_array(g, w, field)


# ---------------------------------------------------------------------------
# the file loaders: tiny upstream-format files, both packages' loaders
# ---------------------------------------------------------------------------


def assert_same(got, want, path="out"):
    """Recursive bit-for-bit comparison of loader outputs: graphs, hetero
    graphs, dicts, sequences, arrays, scipy matrices and scalars."""
    if hasattr(want, "x_dict"):
        for attr in ("x_dict", "edge_index_dict", "y_dict", "edge_weight_dict"):
            assert_same(getattr(got, attr), getattr(want, attr), f"{path}.{attr}")
    elif hasattr(want, "edge_index") and hasattr(want, "x"):
        assert type(got).__name__ == type(want).__name__, path
        for f in ("x", "edge_index", "edge_weight", "y"):
            assert_same(getattr(got, f), getattr(want, f), f"{path}.{f}")
    elif isinstance(want, dict):
        assert sorted(got, key=str) == sorted(want, key=str), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif sp.issparse(want):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert_same_array(got.toarray(), want.toarray(), path)
    elif isinstance(want, (list, tuple)) and not (want and np.isscalar(want[0])):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and list(got) == list(want), path
    elif np.isscalar(want):
        assert got == want and type(got) is type(want), path
    else:
        assert_same_array(got, want, path)


def _load_both(name, *args, **kwargs):
    return (getattr(tds, name)(*args, **kwargs).load_data(),
            getattr(jds, name)(*args, **kwargs).load_data())


@pytest.mark.parametrize("cls", ["CoraDataset", "CiteseerDataset", "SupervisedPubmedDataset"])
def test_planetoid_loader_matches_jax(cls, tmp_path):
    name = {"CoraDataset": "cora", "CiteseerDataset": "citeseer",
            "SupervisedPubmedDataset": "pubmed"}[cls]
    root = _write_planetoid_fixture(str(tmp_path), name)
    got, want = _load_both(cls, dataset_root_path=root)
    assert_same(got, want)
    assert got[0].x.shape == (8, 6)


def test_planetoid_loader_finds_nested_files(tmp_path):
    """An archive that unpacks into a directory: the files one level down."""
    root = _write_planetoid_fixture(str(tmp_path), "cora")
    raw = os.path.join(root, "raw")
    nested = os.path.join(raw, "cora")
    os.makedirs(nested)
    for f in os.listdir(raw):
        if f.startswith("ind."):
            shutil.move(os.path.join(raw, f), nested)
    got = tds.PlanetoidDataset("cora", dataset_root_path=root).load_data()
    want = jds.PlanetoidDataset("cora", dataset_root_path=root).load_data()
    assert_same(got, want)


def test_loaders_without_files_raise_and_do_not_download(tmp_path):
    """No files on disk: the port's loaders raise OSError (the demos' cue
    for the synthetic fallback); none has a URL to fetch."""
    for cls in ("CoraDataset", "TransductiveRedditDataset", "PPIDataset"):
        ds = getattr(tds, cls)(dataset_root_path=str(tmp_path / cls))
        assert ds.download_urls is None
        with pytest.raises(OSError):
            ds.load_data()
    with pytest.raises(OSError):
        tds.TUDataset("NONE", dataset_root_path=str(tmp_path / "tu")).load_data()


def test_tu_loader_matches_jax(tmp_path):
    root = _write_tu_fixture(str(tmp_path), "FAKETU")
    d = os.path.join(root, "raw", "FAKETU")
    with open(os.path.join(d, "FAKETU_edge_labels.txt"), "w") as f:
        f.write("3\n3\n1\n1\n2\n2\n")
    with open(os.path.join(d, "FAKETU_node_attributes.txt"), "w") as f:
        f.write("0.5, 1.0\n1.5, 2.0\n2.5, 3.0\n3.5, 4.0\n4.5, 5.0\n")
    got, want = _load_both("TUDataset", "FAKETU", dataset_root_path=root)
    assert_same(got, want)
    assert os.path.exists(os.path.join(root, "processed", "FAKETU_torch.p"))
    assert_same(tds.TUDataset("FAKETU", dataset_root_path=root).load_data(), want)


def _write_ogb(root):
    raw = os.path.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    rng = np.random.default_rng(2)
    np.savez(os.path.join(raw, "graph.npz"), x=rng.normal(size=(6, 4)).astype(np.float32),
             edge_index=np.array([[0, 1, 2, 3, 1], [1, 2, 3, 4, 0]], np.int64),
             y=rng.integers(0, 3, size=(6, 1)).astype(np.int64),
             train_index=np.arange(0, 3), valid_index=np.arange(3, 4),
             test_index=np.arange(4, 6))


def test_ogb_loader_matches_jax(tmp_path):
    _write_ogb(str(tmp_path))
    got, want = _load_both("OGBNodePropPredDataset", "ogbn-arxiv",
                           dataset_root_path=str(tmp_path))
    assert_same(got, want)
    with pytest.raises(RuntimeError, match="graph.npz"):
        tds.OGBNodePropPredDataset("ogbn-arxiv",
                                   dataset_root_path=str(tmp_path / "none")).process()


@pytest.mark.parametrize("cls", ["TransductiveRedditDataset", "InductiveRedditDataset"])
def test_reddit_loader_matches_jax(cls, tmp_path):
    _write_reddit_fixture(str(tmp_path))
    got, want = _load_both(cls, dataset_root_path=str(tmp_path))
    assert_same(got, want)


def test_ppi_loader_matches_jax(tmp_path):
    nx = pytest.importorskip("networkx")
    raw = os.path.join(str(tmp_path), "raw")
    os.makedirs(raw, exist_ok=True)
    rng = np.random.default_rng(1)
    for split in ("train", "valid", "test"):
        np.save(os.path.join(raw, f"{split}_graph_id.npy"), np.array([1, 1, 1, 2, 2, 2]))
        np.save(os.path.join(raw, f"{split}_feats.npy"), rng.normal(size=(6, 3)))
        np.save(os.path.join(raw, f"{split}_labels.npy"), rng.integers(0, 2, size=(6, 2)))
        g = nx.DiGraph()
        g.add_nodes_from(range(6))
        g.add_edges_from([(0, 1), (1, 2), (2, 0), (3, 4), (5, 3), (4, 3)])
        with open(os.path.join(raw, f"{split}_graph.json"), "w", encoding="utf-8") as fh:
            json.dump(nx.json_graph.node_link_data(g), fh)
    got, want = _load_both("PPIDataset", dataset_root_path=str(tmp_path))
    assert_same(got, want)


def _write_csr_npz(raw, name, seed):
    os.makedirs(raw, exist_ok=True)
    rng = np.random.default_rng(seed)
    attr = sp.csr_matrix(rng.random((7, 5)) * (rng.random((7, 5)) > 0.5))
    adj = sp.csr_matrix((rng.random((7, 7)) > 0.6).astype(np.float32))
    np.savez(os.path.join(raw, f"{name}.npz"), attr_data=attr.data, attr_indices=attr.indices,
             attr_indptr=attr.indptr, attr_shape=attr.shape, adj_data=adj.data,
             adj_indices=adj.indices, adj_indptr=adj.indptr, adj_shape=adj.shape,
             labels=rng.integers(0, 3, 7))


@pytest.mark.parametrize("cls,args", [("CSRNPZDataset", ("fake-csr",)),
                                      ("AmazonComputersDataset", ()),
                                      ("AmazonPhotoDataset", ()),
                                      ("CoauthorCSDataset", ()),
                                      ("CoauthorPhysicsDataset", ())])
def test_csr_npz_loaders_match_jax(cls, args, tmp_path):
    _write_csr_npz(os.path.join(str(tmp_path), "raw"), cls, seed=len(cls))
    got, want = _load_both(cls, *args, dataset_root_path=str(tmp_path))
    assert_same(got, want)


def test_blog_catalog_loader_matches_jax(tmp_path):
    from scipy.io import savemat
    raw = os.path.join(str(tmp_path), "raw")
    os.makedirs(raw)
    rng = np.random.default_rng(3)
    savemat(os.path.join(raw, "multi_label_blog_catalog.mat"),
            {"network": sp.csr_matrix((rng.random((8, 8)) > 0.6).astype(np.float64)),
             "group": sp.csr_matrix((rng.random((8, 3)) > 0.5).astype(np.float64))})
    got, want = _load_both("MultiLabelBlogCatalogDataset", dataset_root_path=str(tmp_path))
    assert_same(got, want)


@pytest.mark.parametrize("cls,name", [("FDYelpChiDataset", "fd_yelp_chi"),
                                      ("FDAmazonDataset", "fd_amazon")])
def test_abnormal_loaders_match_jax(cls, name, tmp_path):
    from scipy.io import savemat
    raw = os.path.join(str(tmp_path), "raw")
    os.makedirs(raw)
    rng = np.random.default_rng(4)
    n = 7
    savemat(os.path.join(raw, f"{name}.mat"), {
        "features": sp.csr_matrix(rng.random((n, 5))),
        "label": rng.integers(0, 2, n).astype(np.float64),
        "net_rur": sp.csr_matrix((rng.random((n, n)) > 0.5).astype(np.float64)),
        "homo": sp.csr_matrix((rng.random((n, n)) > 0.5).astype(np.float64))})
    got, want = _load_both(cls, dataset_root_path=str(tmp_path))
    assert_same(got, want)


def _write_hgb_freebase(root):
    raw = os.path.join(root, "raw", "freebase")
    os.makedirs(raw)
    files = {"info.dat": "Freebase info\n\nTYPE\tMEANING\n0\t\tBOOK\n1\t\tFILM\n\n"
                         "LINK\tSTART\tEND\tMEANING\n0\t0\t1\tbook-film\n1\t1\t1\tfilm-film\n\n",
             "node.dat": "0\tb0\t0\n1\tb1\t0\n2\tf0\t1\n3\tf1\t1\n",
             "link.dat": "0\t2\t0\t1.0\n1\t2\t0\t1.0\n2\t3\t1\t0.5\n",
             "label.dat": "0\tb0\t0\t1\n", "label.dat.test": "1\tb1\t0\t0\n"}
    for name, text in files.items():
        with open(os.path.join(raw, name), "w", encoding="utf-8") as f:
            f.write(text)


@pytest.mark.parametrize("cls", ["HGBACMDataset", "HGBFreebaseDataset"])
def test_hgb_loaders_match_jax(cls, tmp_path):
    (_write_hgb_acm_fixture if cls == "HGBACMDataset" else _write_hgb_freebase)(str(tmp_path))
    got, want = _load_both(cls, dataset_root_path=str(tmp_path))
    assert type(got[0]).__name__ == "HeteroGraph"
    assert_same(got, want)


def test_nars_acm_loader_matches_jax(tmp_path):
    """The split comes from numpy's global generator on both sides: seeded
    the same before each."""
    from scipy.io import savemat
    raw = os.path.join(str(tmp_path), "raw")
    os.makedirs(raw)
    rng = np.random.default_rng(5)
    pvsc = np.zeros((8, 14))
    for p, c in zip(range(7), (0, 1, 9, 13, 10, 0, 1)):
        pvsc[p, c] = 1.0
    savemat(os.path.join(raw, "acm.mat"), {
        "PvsL": sp.csr_matrix((rng.random((8, 2)) > 0.4).astype(np.float64)),
        "PvsA": sp.csr_matrix((rng.random((8, 3)) > 0.4).astype(np.float64)),
        "PvsT": sp.csr_matrix(rng.random((8, 5))), "PvsC": sp.csr_matrix(pvsc)})
    np.random.seed(7)
    got = tds.NARSACMDataset(dataset_root_path=str(tmp_path)).load_data()
    np.random.seed(7)
    want = jds.NARSACMDataset(dataset_root_path=str(tmp_path)).load_data()
    assert_same(got, want)


def test_model_net_loader_matches_jax(tmp_path):
    """JAX's pool returns each directory's graphs in completion order, the
    port's in listing order: compared as sets of (label, x, edges)."""
    from tf_geometric_tpu.datasets.model_net import ModelNetDataset as JModelNetDataset
    from tf_geometric_tpu_torch.datasets.model_net import ModelNetDataset
    base = os.path.join(str(tmp_path), "raw", "FakeModelNet")
    for label in ("chair", "desk"):
        for split, names in (("train", ("a.off", "b.off")), ("test", ("c.off",))):
            os.makedirs(os.path.join(base, label, split))
            for i, name in enumerate(names):
                body = _OFF_QUAD if (label == "desk" and i == 0) else _OFF_TETRA
                with open(os.path.join(base, label, split, name), "w", encoding="utf-8") as f:
                    f.write(body)
    got = ModelNetDataset("FakeModelNet", dataset_root_path=str(tmp_path),
                          num_processes=2).process()
    want = JModelNetDataset("FakeModelNet", dataset_root_path=str(tmp_path),
                            num_processes=2).process()
    assert got[2] == want[2] == ["chair", "desk"]

    def key(g):
        return (int(np.asarray(g.y)[0]), np.asarray(g.x).tobytes(),
                np.asarray(g.edge_index).tobytes())

    for split in (0, 1):
        assert len(got[split]) == len(want[split])
        for g, w in zip(sorted(got[split], key=key), sorted(want[split], key=key)):
            assert_same(g, w)


def test_dataset_exports_cover_jax():
    """Every name JAX's ``datasets`` exports has a port counterpart."""
    jax_names = [n for n in dir(jds) if not n.startswith("_") and n[0].isupper()
                 or n.startswith("synthetic")]
    missing = [n for n in jax_names if not hasattr(tds, n)]
    assert not missing, missing
