"""paddle_tpu_torch.tp_serving — disaggregated prefill / decode, the
part of `paddle_tpu.tp_serving` that runs on one card.

* `KVHandoff` — one prefilled request's pages, token 0 and geometry,
  from a prefill engine to a decode engine;
* `DisaggPair` — a prefill-role and a decode-role `GenerationEngine`
  (the DistServe split): the decode engine never prefills;
* `ShardGroupFleet` — routes requests over such groups by decode
  headroom.

Tensor-parallel engines, expert-parallel MoE and the TP layout are
multi-GPU work and are not ported yet.
"""

from .disagg import (  # noqa: F401
    DisaggPair,
    KVHandoff,
    ShardGroupFleet,
    extract_prefilled,
    inject_prefilled,
)

__all__ = [
    "DisaggPair",
    "KVHandoff",
    "ShardGroupFleet",
    "extract_prefilled",
    "inject_prefilled",
]
