"""On-card candidate retrieval: the embedding bank (K7), single device.

Port of ``albedo_tpu/retrieval`` without ``stage.py`` (the two-stage
pipeline's bank stage) and without the mesh layout: one card-resident bank
answers every embedding-backed source (ALS factors, Word2Vec content
vectors, TF-IDF rows, user rows) with one K7 launch per source and batch.
"""

from albedo_tpu_torch.retrieval.bank import BankSourceSpec, RetrievalBank, mean_query_vectors
from albedo_tpu_torch.retrieval.build import build_default_bank, default_bank_specs
from albedo_tpu_torch.retrieval.parity import candidate_parity

__all__ = [
    "BankSourceSpec",
    "RetrievalBank",
    "build_default_bank",
    "candidate_parity",
    "default_bank_specs",
    "mean_query_vectors",
]
