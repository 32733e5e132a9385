"""Feature-engineering layer (L2): the Estimator/Transformer protocol and the
concrete transformers the profile builders and ranker pipelines compose.

Reference parity: ``src/main/scala/ws/vinta/albedo/transformers/`` and the two
forked Spark classes (``SimpleVectorAssembler``, ``FuncTransformer``). The
assembly target differs by design: instead of one giant sparse vector column
(million-wide one-hots over user_id/repo_id,
``LogisticRegressionRanker.scala:156-157``), features assemble into a
``FeatureMatrix`` of dense blocks + categorical index fields + padded bag
fields that TPU kernels consume as gathers and segment-sums
(SURVEY.md §7 hard part (e)).

Host code, copied from ``albedo_tpu/features/__init__.py`` with its imports pointed at
the port; the port keeps its own copy so that it never imports the JAX
package.
"""

from albedo_tpu_torch.features.assembler import FeatureAssembler, FeatureMatrix
from albedo_tpu_torch.features.balancer import NegativeBalancer
from albedo_tpu_torch.features.cross import UserRepoTransformer
from albedo_tpu_torch.features.indexers import FrequencyBinner, StringIndexer, StringIndexerModel
from albedo_tpu_torch.features.pipeline import Estimator, FuncTransformer, Pipeline, PipelineModel, Transformer
from albedo_tpu_torch.features.text import (
    CountVectorizer,
    CountVectorizerModel,
    HanLPTokenizer,
    SnowballStemmer,
    StopWordsRemover,
    Tokenizer,
)
from albedo_tpu_torch.features.weights import InstanceWeigher

__all__ = [
    "CountVectorizer",
    "CountVectorizerModel",
    "Estimator",
    "FeatureAssembler",
    "FeatureMatrix",
    "FrequencyBinner",
    "FuncTransformer",
    "HanLPTokenizer",
    "InstanceWeigher",
    "NegativeBalancer",
    "Pipeline",
    "PipelineModel",
    "SnowballStemmer",
    "StopWordsRemover",
    "StringIndexer",
    "StringIndexerModel",
    "Tokenizer",
    "Transformer",
    "UserRepoTransformer",
]
