from .minilm import MiniLMEncoder, SentenceEncoder

__all__ = ["MiniLMEncoder", "SentenceEncoder"]
