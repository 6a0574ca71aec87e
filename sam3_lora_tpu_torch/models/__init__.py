from .builder import build_sam3_image_model, dummy_batch, init_model  # noqa: F401
from .geometry import GeoPrompt  # noqa: F401
from .layers import Spec  # noqa: F401
from .sam3_image import Batch, Sam3Image, Targets  # noqa: F401
