"""Multi-device and multi-host search: the data mesh, the mesh engines, the
interval-parallel search and the multi-host runner."""

from sahara_tpu_torch.parallel.mesh import data_mesh, replicate_index, shard_queries
from sahara_tpu_torch.parallel.search import distributed_scheme_search
