"""Global configuration constants for notorch-tpu.

Capability parity: reference ``notorch/conf.py:6-12``.
"""

INPUT_KEY_PREFIX = "inputs"
TARGET_KEY_PREFIX = "targets"

DEFAULT_HIDDEN_DIM = 256

# Default bucket boundaries (nodes, edges) for static-shape padding of ragged
# molecule batches. Tuned so that most MoleculeNet-scale molecules land in the
# first couple of buckets while keeping XLA recompilation count small.
DEFAULT_NODE_BUCKETS = (16, 32, 64, 128, 256)
DEFAULT_EDGE_BUCKETS = (32, 64, 128, 256, 512)
