"""Live train-to-serve weight sync: versioned mask-delta publisher and
subscriber (port of ``repro/sync``; the same records on the wire).

The condensed constant fan-in export is the wire format: per-stack topology
records carry ``indices`` and ``values`` (and ``scales``/``out_index`` where
the leaf has them), stacks whose mask did not move ship values only, and a
per-stack ``(mask_version, generation)`` header with an all-or-nothing
generation commit keeps a subscriber's stacks coherent mid-stream.

- ``repro_torch.sync.delta``: checksummed binary records (``Delta`` /
  ``Snapshot``) that round-trip every ``sparse.formats`` leaf, quantized
  ``values_dtype`` and bfloat16 values included, as host tensors.
- ``repro_torch.sync.channel``: an in-process ``QueueChannel`` and a
  multi-process ``DirChannel`` (atomically renamed record files), both with
  a resync back-channel.
- ``repro_torch.sync.publisher`` / ``repro_torch.sync.subscriber``: the
  trainer-side diff and the replica-side generation handshake (stale
  records dropped, gaps answered by a snapshot resync, never a partial
  apply).

The engine side is ``launch.engine.ServingEngine.attach_subscriber``, the
trainer side ``train.trainer.Trainer(publisher=...)``.
"""

from repro_torch.sync.delta import (  # noqa: F401
    Delta,
    DeltaCorruptError,
    Snapshot,
    StackDelta,
    UnsupportedStreamError,
    decode,
    encode,
)
from repro_torch.sync.channel import DirChannel, QueueChannel  # noqa: F401
from repro_torch.sync.publisher import Publisher  # noqa: F401
from repro_torch.sync.subscriber import Subscriber, engine_from_snapshot  # noqa: F401
