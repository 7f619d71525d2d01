from .synthetic import SyntheticDataset, make_synthetic_batch, to_torch  # noqa: F401
