"""paddle.io of the port (``paddle_tpu/io``'s counterpart): datasets,
samplers and the DataLoader."""
from .dataloader import DataLoader, default_collate_fn  # noqa: F401
from .dataset import (  # noqa: F401
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset,
    Subset, TensorDataset, random_split,
)
from .sampler import (  # noqa: F401
    BatchSampler, DistributedBatchSampler, RandomSampler, Sampler,
    SequenceSampler, SubsetRandomSampler, WeightedRandomSampler, epoch_seed,
)
