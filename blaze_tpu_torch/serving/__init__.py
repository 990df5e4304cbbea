"""The port's query service (port of blaze_tpu/serving/).

A bounded admission queue with per-tenant quotas and load shedding
(`service.QueryService`), the per-query deadline, cooperative
cancellation and memory-quota degradation (`context.QueryContext`), the
live progress registry (`progress`), and the failure taxonomy callers
program against (`QueryRejected`, `QueryCancelled`, `DeadlineExceeded`,
`QueryMemoryExceeded`).
"""

from blaze_tpu_torch.serving.context import (DeadlineExceeded,
                                             QueryCancelled, QueryContext,
                                             QueryMemoryExceeded)
from blaze_tpu_torch.serving.service import (QueryHandle, QueryRejected,
                                             QueryService, cancel_query,
                                             serving_stats)

__all__ = ["QueryContext", "QueryCancelled", "DeadlineExceeded",
           "QueryMemoryExceeded", "QueryService", "QueryHandle",
           "QueryRejected", "serving_stats", "cancel_query"]
