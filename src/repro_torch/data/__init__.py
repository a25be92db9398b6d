"""The paper's datasets (Sec. V-A1): a byte-identical copy of the reference's."""
from repro_torch.data import datasets  # noqa: F401
