"""Model substrate of the PyTorch port (paged serving path)."""
from repro_torch.models.model import (  # noqa: F401
    init_paged_cache,
    supports_paged_cache,
)
