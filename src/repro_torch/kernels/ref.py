"""Plain torch oracles for the ported kernels, under the names of the JAX
package's ``repro.kernels.ref``.

Each is the plain version that lives beside its kernel; this module only
gives it the reference's name, so tests hold ``repro.kernels.ref.X``
against ``repro_torch.kernels.ref.X``. The oracles of the kernels not yet
ported (``simcount``, ``tokenize_hash``, ``match_extract``,
``distinct_counts``) come with their slices.
"""

from __future__ import annotations

from .colcodec import colcodec_transform_plain as colcodec_transform_ref
from .wildcard_match import PAD_ID, STAR_ID
from .wildcard_match import wildcard_match_plain as wildcard_match_ref

__all__ = ["PAD_ID", "STAR_ID", "colcodec_transform_ref", "wildcard_match_ref"]
