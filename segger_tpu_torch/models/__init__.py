from .encoder import ISTEncoder
from .gatv2 import GATv2Conv
from .positional import Positional2dEmbedder

__all__ = ["ISTEncoder", "GATv2Conv", "Positional2dEmbedder"]
