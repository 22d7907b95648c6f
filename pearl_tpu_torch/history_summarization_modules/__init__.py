from pearl_tpu_torch.history_summarization_modules.frame_ring import (
    FrameRingHistorySummarization,
    FrameRingView,
)
from pearl_tpu_torch.history_summarization_modules.modules import (
    HistorySummarizationModule,
    IdentityHistorySummarization,
    LSTMHistorySummarization,
    StackingHistorySummarization,
    TransformerHistorySummarization,
)

__all__ = [
    "FrameRingHistorySummarization",
    "FrameRingView",
    "HistorySummarizationModule",
    "IdentityHistorySummarization",
    "LSTMHistorySummarization",
    "StackingHistorySummarization",
    "TransformerHistorySummarization",
]
