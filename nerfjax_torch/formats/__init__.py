"""Volume file writers (the port's own copy of ``nerfjax/formats``: multi-page
TIFF and VTK ImageData, struct + numpy; ``tests/test_torch_postprocess.py``
holds the files they write byte-equal to nerfjax's)."""

from nerfjax_torch.formats.tiff import write_tiff_volume
from nerfjax_torch.formats.vti import write_vti_volume

__all__ = ["write_tiff_volume", "write_vti_volume"]
