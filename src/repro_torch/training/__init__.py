"""Training substrate: optimizer, train step, training state."""
from repro_torch.training import optimizer, step  # noqa: F401
