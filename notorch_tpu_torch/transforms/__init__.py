from notorch_tpu_torch.transforms.atom import (
    AtomTransform,
    ElementOnlyAtomTransform,
    MultiTypeAtomTransform,
)
from notorch_tpu_torch.transforms.base import GraphTransform, Pipeline, Transform
from notorch_tpu_torch.transforms.bond import (
    BondTransform,
    BondTypeOnlyTransform,
    MultiTypeBondTransform,
)
from notorch_tpu_torch.transforms.chem import SmiToMol, add_hs
from notorch_tpu_torch.transforms.graph import MolToGraph
from notorch_tpu_torch.transforms.mol import MolToFP, morgan

__all__ = [
    "AtomTransform",
    "BondTransform",
    "BondTypeOnlyTransform",
    "ElementOnlyAtomTransform",
    "GraphTransform",
    "MolToFP",
    "MolToGraph",
    "MultiTypeAtomTransform",
    "MultiTypeBondTransform",
    "Pipeline",
    "SmiToMol",
    "Transform",
    "add_hs",
    "morgan",
]
