"""repro_torch.compress — the szlike base codec, the MSE1 edit codec,
the artifact format and the end-to-end MSS-preserving pipeline."""
from .szlike import (TruncatedStreamError, check_int32_range,
                     effective_step, sz_blob_entropy, sz_compress,
                     sz_decompress, sz_encode_packed, sz_inverse,
                     sz_parse_packed, sz_transform)
from .codec import encode_edits, decode_edits, decode_edits_batch
from .preserve import (CompressedArtifact, PreservingCodec,
                       register_preserving_codec, get_preserving_codec,
                       available_preserving_codecs, payload_codec,
                       payload_magic, check_artifact, decode_payload,
                       resolve_edit_dtype, exact_edit_dtype)
from .pipeline import (compress_preserving_mss, compress_preserving_mss_batch,
                       decompress_artifact, decompress_artifact_batch,
                       decompress_preserving_mss, overall_compression_ratio)

__all__ = [
    "TruncatedStreamError", "check_int32_range", "effective_step",
    "sz_blob_entropy", "sz_compress", "sz_decompress", "sz_encode_packed",
    "sz_inverse", "sz_parse_packed", "sz_transform", "encode_edits",
    "decode_edits", "decode_edits_batch",
    "CompressedArtifact", "PreservingCodec", "register_preserving_codec",
    "get_preserving_codec", "available_preserving_codecs", "payload_codec",
    "payload_magic", "check_artifact", "decode_payload",
    "resolve_edit_dtype", "exact_edit_dtype",
    "compress_preserving_mss", "compress_preserving_mss_batch",
    "decompress_artifact", "decompress_artifact_batch",
    "decompress_preserving_mss", "overall_compression_ratio",
]
