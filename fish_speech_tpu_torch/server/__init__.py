from fish_speech_tpu_torch.server.app import create_app

__all__ = ["create_app"]
