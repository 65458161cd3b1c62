"""Persistence (port of filodb_tpu/persist/): the local-disk column and
meta stores, columnar segments and the compactor.  The object store and
the network store are not ported yet."""
from filodb_tpu_torch.persist.localstore import (LocalDiskColumnStore,
                                                 LocalDiskMetaStore)

__all__ = ["LocalDiskColumnStore", "LocalDiskMetaStore"]
