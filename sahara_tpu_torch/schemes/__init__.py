from sahara_tpu_torch.schemes.types import Search, Scheme, is_valid, is_complete, is_non_redundant
from sahara_tpu_torch.schemes.expand import expand, expand_count, limit_to_hamming
from sahara_tpu_torch.schemes.generators import GENERATORS, get_generator
from sahara_tpu_torch.schemes.costs import node_count, weighted_node_count
