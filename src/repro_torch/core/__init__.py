"""Weight-sharing embedding core of the port: QR index math, embedding and
bag configs, hot-tier planning and the packed multi-table layout."""

from repro_torch.core.embedding_bag import BagConfig  # noqa: F401
from repro_torch.core.qr_embedding import EmbeddingConfig  # noqa: F401
