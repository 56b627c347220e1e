from fish_speech_tpu_torch.i18n.core import i18n

__all__ = ["i18n"]
