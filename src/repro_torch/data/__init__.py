from repro_torch.data.pipeline import (
    DataConfig,
    synthetic_lm_batches,
    text_file_batches,
    pack_documents,
)
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["DataConfig", "synthetic_lm_batches", "text_file_batches",
           "pack_documents", "ByteTokenizer"]
