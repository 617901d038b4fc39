"""Multi-device paths on ``torch.distributed``: point-sharded bundle
adjustment (``sharded_ba``), the ranks it runs on (``ranks``), and the
multi-sequence session runner (``multi_sequence``)."""
from sivo_tpu_torch.parallel import sharded_ba as sharded_ba  # noqa: F401
