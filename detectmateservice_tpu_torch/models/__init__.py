from .tokenizer import HashTokenizer, PAD_ID, MASK_ID, CLS_ID
from .mlp import MLPScorer, MLPScorerConfig, EmbedMLPModel

__all__ = [
    "HashTokenizer", "PAD_ID", "MASK_ID", "CLS_ID",
    "MLPScorer", "MLPScorerConfig", "EmbedMLPModel",
]
