"""Avro record schemas matching the reference's interchange formats.

Counterpart of photon-avro-schemas/src/main/avro/*.avsc (8 records). Field
names, types, and defaults must match the reference byte-for-byte so that
models/data written by either framework load in the other
(BayesianLinearModelAvro is the model checkpoint format, README.md:205).
Expressed as Avro-JSON Python dicts consumed by photon_ml_tpu_torch.io.avro.
The port's own copy of `photon_ml_tpu/io/schemas.py`.
"""

from __future__ import annotations

NAMESPACE = "com.linkedin.photon.avro.generated"

NAME_TERM_VALUE = {
    "name": "NameTermValueAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

FEATURE = {
    "name": "FeatureAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

BAYESIAN_LINEAR_MODEL = {
    "name": "BayesianLinearModelAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {"name": "means", "type": {"type": "array", "items": NAME_TERM_VALUE}},
        {
            "name": "variances",
            "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
            "default": None,
        },
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
    ],
}

TRAINING_EXAMPLE = {
    "name": "TrainingExampleAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": FEATURE}},
        {"name": "weight", "type": "double", "default": 1.0},
        {"name": "offset", "type": "double", "default": 0.0},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
    ],
}

RESPONSE_PREDICTION = {
    "name": "SimplifiedResponsePrediction",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "response", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": FEATURE}},
        {"name": "weight", "type": "double", "default": 1.0},
        {"name": "offset", "type": "double", "default": 0.0},
    ],
}

SCORING_RESULT = {
    "name": "ScoringResultAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": ["null", "double"], "default": None},
        {"name": "modelId", "type": "string"},
        {"name": "predictionScore", "type": "double"},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
    ],
}

FEATURE_SUMMARIZATION = {
    "name": "FeatureSummarizationResultAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "featureName", "type": "string"},
        {"name": "featureTerm", "type": "string"},
        {"name": "metrics", "type": {"type": "map", "values": "double"}},
    ],
}

LATENT_FACTOR = {
    "name": "LatentFactorAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "effectId", "type": "string"},
        {"name": "latentFactor", "type": {"type": "array", "items": "double"}},
    ],
}
