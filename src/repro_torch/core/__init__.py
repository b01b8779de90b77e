"""repro_torch.core — MSz itself on PyTorch: grid stencils, MSS labels,
the fused and paper-mode fix loops, the stencil backends and the
high-level API."""
from .grid import (OFFSETS_2D, OFFSETS_3D, offsets_for, n_neighbors,
                   self_code, steepest_dirs, gather_dir, dir_to_pointer,
                   shift, linear_index)
from .labels import (mss_labels, pointer_jump, default_pointer_iters,
                     segmentation_accuracy, labels_from_codes)
from .backend import (StencilMasks, ReferenceBackend, CudaBackend,
                      register_backend, available_backends, get_backend,
                      resolve_backend, false_critical_masks, trouble_masks)
from .fixes import (FieldTopo, field_topology, fused_pass, fused_fix,
                    fused_fix_batch, fused_fix_worklist, paper_fix)
from .driver import (MszResult, derive_edits, derive_edits_batch,
                     extract_edits, apply_edits, apply_edits_device,
                     verify_preservation, verify_preservation_batch)

__all__ = [
    "OFFSETS_2D", "OFFSETS_3D", "offsets_for", "n_neighbors", "self_code",
    "steepest_dirs", "gather_dir", "dir_to_pointer", "shift", "linear_index",
    "mss_labels", "pointer_jump", "default_pointer_iters",
    "segmentation_accuracy", "labels_from_codes",
    "StencilMasks", "ReferenceBackend", "CudaBackend",
    "register_backend", "available_backends", "get_backend",
    "resolve_backend", "false_critical_masks", "trouble_masks",
    "FieldTopo", "field_topology", "fused_pass", "fused_fix",
    "fused_fix_batch", "fused_fix_worklist", "paper_fix",
    "MszResult", "derive_edits", "derive_edits_batch", "extract_edits",
    "apply_edits", "apply_edits_device", "verify_preservation",
    "verify_preservation_batch",
]
