from .datasets import create_dataset  # noqa: F401
from .imresize import imresize, resize_matrix  # noqa: F401
from .loader import DataLoader, EnlargedSampler, create_dataloader  # noqa: F401
