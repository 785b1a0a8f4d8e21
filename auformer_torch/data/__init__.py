"""The data layer (counterpart of auformer/data): FrameStores and their
native reader, the split builder, the datasets, samplers and loader, the
wav arena (wav_arena.py) and the host AutoAugment (transforms.py)."""
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
