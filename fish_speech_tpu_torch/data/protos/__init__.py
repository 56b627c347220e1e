from fish_speech_tpu_torch.data.protos.text_data_pb2 import (
    SampledData,
    Semantics,
    Sentence,
    TextData,
)

__all__ = ["TextData", "SampledData", "Sentence", "Semantics"]
