"""Model zoo: the transformer LM the decode path serves."""
from . import transformer
