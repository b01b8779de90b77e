"""repro_torch.compress — the szlike and zfplike base codecs, the MSE1
edit codec, the artifact format, the end-to-end MSS-preserving pipeline,
the streaming scheduler, and the paper's metric helpers (the lossless
baselines, overall bit rate, PSNR)."""
from .szlike import (TruncatedStreamError, check_int32_range,
                     effective_step, sz_blob_entropy, sz_compress,
                     sz_decompress, sz_encode_packed, sz_inverse,
                     sz_parse_packed, sz_roundtrip, sz_transform)
from .zfplike import zfp_compress, zfp_decompress, zfp_roundtrip
from .codec import (encode_edits, decode_edits, decode_edits_batch,
                    lossless_bytes, gzip_like, zstd_like)
from .preserve import (CompressedArtifact, PreservingCodec,
                       register_preserving_codec, get_preserving_codec,
                       available_preserving_codecs, payload_codec,
                       payload_magic, check_artifact, decode_payload,
                       resolve_edit_dtype, exact_edit_dtype)
from .pipeline import (compress_preserving_mss, compress_preserving_mss_batch,
                       decompress_artifact, decompress_artifact_batch,
                       decompress_preserving_mss, overall_compression_ratio,
                       overall_bit_rate, psnr)
from .stream import (CompressStream, DecompressStream, SpecCache,
                     StreamBackpressure, StreamClosed)

__all__ = [
    "CompressStream", "DecompressStream", "SpecCache",
    "StreamBackpressure", "StreamClosed",
    "zfp_compress", "zfp_decompress", "zfp_roundtrip",
    "TruncatedStreamError", "check_int32_range", "effective_step",
    "sz_blob_entropy", "sz_compress", "sz_decompress", "sz_encode_packed",
    "sz_inverse", "sz_parse_packed", "sz_roundtrip", "sz_transform",
    "encode_edits", "decode_edits", "decode_edits_batch",
    "lossless_bytes", "gzip_like", "zstd_like",
    "CompressedArtifact", "PreservingCodec", "register_preserving_codec",
    "get_preserving_codec", "available_preserving_codecs", "payload_codec",
    "payload_magic", "check_artifact", "decode_payload",
    "resolve_edit_dtype", "exact_edit_dtype",
    "compress_preserving_mss", "compress_preserving_mss_batch",
    "decompress_artifact", "decompress_artifact_batch",
    "decompress_preserving_mss", "overall_compression_ratio",
    "overall_bit_rate", "psnr",
]
