from ddpo_torch.data.hdf5 import (
    H5Reader,
    H5Writer,
    LocalReader,
    RemoteReader,
    RemoteWriter,
    SlowRemoteReader,
)
from ddpo_torch.data.bucket import (
    BucketDataset,
    bucket_loader,
    get_bucket_loader,
    make_uncond_text,
)

__all__ = [
    "H5Reader",
    "H5Writer",
    "LocalReader",
    "RemoteReader",
    "RemoteWriter",
    "SlowRemoteReader",
    "BucketDataset",
    "bucket_loader",
    "get_bucket_loader",
    "make_uncond_text",
]
