"""paddle_tpu_torch.generation — the continuous-batching decoding engine
of `paddle_tpu.generation`, on PyTorch and the port's CUDA kernels.

* `PagedKVCache` / `BlockPool` — the block-pool KV store and its
  refcounted lowest-id-first allocator (block 0 is the garbage block);
  `KVCache` keeps the dense layout as the A/B baseline;
* `GenerationEngine` — slot-based continuous batching, flash prefill
  over the bucket ladder, one decode step over all slots per iteration
  through the paged (or dense) decode kernel, preemption on pool
  exhaustion; token-for-token equal to `sequential_oracle`;
* `SamplingParams` / `sample_tokens` — greedy, temperature, top-k,
  top-p with per-request (seed, step) random streams.
"""

from .engine import (  # noqa: F401
    EngineDeadError,
    GenerationEngine,
    GenerationRequest,
    RequestHandle,
    ShedError,
    default_prefill_buckets,
    sequential_oracle,
)
from .kv_cache import (  # noqa: F401
    BlockPool,
    KVCache,
    PagedKVCache,
    PoolExhausted,
)
from .sampling import (  # noqa: F401
    SamplingParams,
    sample_tokens,
    stream_generator,
    token_logprobs,
)
