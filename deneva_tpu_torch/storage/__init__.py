"""Storage layer (reference `storage/`): catalog, tables, indexes.

A table is a structure of arrays resident on the device, one tensor per
column, accessed by vectorized gather/scatter over slot ids.
"""

from deneva_tpu_torch.storage.catalog import (Catalog, Column,  # noqa: F401
                                              TableSchema, parse_schema)
from deneva_tpu_torch.storage.index import (DenseIndex,  # noqa: F401
                                            HashIndex, SortedIndex)
from deneva_tpu_torch.storage.table import DeviceTable  # noqa: F401
