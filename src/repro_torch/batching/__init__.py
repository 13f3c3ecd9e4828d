from repro_torch.batching.static import pad_batch, bucket_length, StaticBatcher  # noqa: F401
from repro_torch.batching.kvcache import PagedKVAllocator, PageTable  # noqa: F401
from repro_torch.batching.continuous import ContinuousBatcher, SlotState  # noqa: F401
from repro_torch.batching.policy import (BatchPolicy, PrefillPlan,  # noqa: F401
                                         SlotCountPolicy, TokenBudgetPolicy,
                                         LengthSortedPolicy,
                                         ChunkedPrefillPolicy, BATCH_POLICIES,
                                         make_batch_policy)
