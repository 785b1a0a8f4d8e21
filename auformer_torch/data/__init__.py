"""The data layer (counterpart of auformer/data): FrameStores and their
native reader, the split builder, the datasets, samplers and loader. The
JAX package's wav arena (ROADMAP.md queue A12) and host augmentation (A10)
are not ported."""
from .framestore import FrameStore, FrameStoreWriter, open_store
from .samplers import (DataLoader, Prefetcher, SubsetRandomSampler,
                       SubsetSequentialSampler, BlockShuffleSampler,
                       collate, shard_indices)
from .dataset import Aff2CompDataset
from .testset import Aff2TestDataset
from .split import create_dataset_split

__all__ = [
    "FrameStore", "FrameStoreWriter", "open_store",
    "DataLoader", "Prefetcher", "SubsetRandomSampler",
    "SubsetSequentialSampler", "BlockShuffleSampler", "collate",
    "shard_indices",
    "Aff2CompDataset", "Aff2TestDataset", "create_dataset_split",
]
