"""Primary beams (torch)."""

from .analytic import (
    bessel_j1, airy_beam, gaussian_beam, dipole_beam,
    ground_plane_pattern, vla_pbcor_beam, gmrt_beam,
    uniform_rect_aperture_beam, uniform_square_aperture_beam,
    array_field_pattern, mwa_tile_positions,
    generic_aperture_field_pattern, feed_illumination_of_aperture,
    feed_aperture_combined_field_pattern,
)
from .dispatch import primary_beam
from .external import ExternalBeam
from .jones import dipole_jones, mueller_from_jones, mueller_unpol_weights

__all__ = ["bessel_j1", "airy_beam", "gaussian_beam", "dipole_beam",
           "ground_plane_pattern", "vla_pbcor_beam", "gmrt_beam",
           "uniform_rect_aperture_beam", "uniform_square_aperture_beam",
           "array_field_pattern", "mwa_tile_positions",
           "generic_aperture_field_pattern",
           "feed_illumination_of_aperture",
           "feed_aperture_combined_field_pattern", "primary_beam",
           "ExternalBeam", "dipole_jones", "mueller_unpol_weights",
           "mueller_from_jones"]
