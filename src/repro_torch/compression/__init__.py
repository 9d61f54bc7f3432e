from repro_torch.compression.topk import (
    CompressionState,
    compress_decompress,
    init_compression,
    wire_bytes_saved,
)

__all__ = ["CompressionState", "compress_decompress", "init_compression", "wire_bytes_saved"]
