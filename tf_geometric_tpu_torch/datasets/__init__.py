"""The dataset zoo (JAX counterpart: ``tf_geometric_tpu/datasets``): the
file loaders, which read only files already on disk, and the synthetic
generators, bit for bit with the JAX package's for the same seed."""
from .abnormal import FDAmazonDataset, FDYelpChiDataset
from .amazon_electronics import (AmazonComputersDataset, AmazonElectronicsDataset,
                                 AmazonPhotoDataset)
from .blog_catalog import MultiLabelBlogCatalogDataset
from .coauthor import CoauthorCSDataset, CoauthorDataset, CoauthorPhysicsDataset
from .csr_npz import CSRNPZDataset
from .hgb import HGBACMDataset, HGBDataset, HGBDBLPDataset, HGBFreebaseDataset, HGBIMDBDataset
from .model_net import ModelNet10Dataset, ModelNet40Dataset
from .nars_academic import NARSACMDataset
from .ogb import OGBNodePropPredDataset
from .planetoid import (CiteseerDataset, CoraDataset, PlanetoidDataset, PubmedDataset,
                        SupervisedCiteseerDataset, SupervisedCoraDataset,
                        SupervisedPubmedDataset)
from .ppi import PPIDataset
from .reddit import InductiveRedditDataset, TransductiveRedditDataset
from .synthetic_citation import (FakePlanetoidDataset, HardCitationDataset, flip_graph_labels,
                                 synthetic_citation_graph, synthetic_graph_classification,
                                 synthetic_graph_classification_hard, synthetic_ogbn_arxiv_like)
from .synthetic_reddit import synthetic_reddit_like
from .tu import TUDataset

__all__ = ["PPIDataset", "TUDataset", "PlanetoidDataset", "CoraDataset", "CiteseerDataset",
           "PubmedDataset", "SupervisedCoraDataset", "SupervisedCiteseerDataset",
           "SupervisedPubmedDataset", "MultiLabelBlogCatalogDataset",
           "TransductiveRedditDataset", "InductiveRedditDataset", "OGBNodePropPredDataset",
           "ModelNet10Dataset", "ModelNet40Dataset", "CSRNPZDataset",
           "AmazonElectronicsDataset", "AmazonComputersDataset", "AmazonPhotoDataset",
           "CoauthorDataset", "CoauthorCSDataset", "CoauthorPhysicsDataset",
           "FDAmazonDataset", "FDYelpChiDataset", "HGBDataset", "HGBACMDataset",
           "HGBDBLPDataset", "HGBFreebaseDataset", "HGBIMDBDataset", "NARSACMDataset",
           "synthetic_citation_graph", "synthetic_ogbn_arxiv_like", "FakePlanetoidDataset",
           "HardCitationDataset", "flip_graph_labels", "synthetic_graph_classification",
           "synthetic_graph_classification_hard", "synthetic_reddit_like"]
