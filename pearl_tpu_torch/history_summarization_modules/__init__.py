from pearl_tpu_torch.history_summarization_modules.modules import (
    HistorySummarizationModule,
    IdentityHistorySummarization,
)

__all__ = ["HistorySummarizationModule", "IdentityHistorySummarization"]
