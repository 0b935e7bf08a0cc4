"""repro_torch.core — PCILT quantization, offsets, table builds and layers."""

from .quantization import (QuantSpec, scale_from_amax, calibrate, quantize,
                           quantize_with_stats, dequantize, fake_quant,
                           code_values)
from .offsets import pack_offsets, unpack_offsets, offset_grid
from .pcilt import (table_bytes, grouped_table_bytes, shared_table_bytes,
                    build_cost_multiplies, build_grouped_tables,
                    build_paired_tables, build_paired_stacked_tables,
                    SharedGroupedTables,
                    build_shared_grouped_tables, table_checksum,
                    layer_checksum, stacked_checksums)
from .lut_layers import (conv_same_pads, lut_lookup, pcilt_linear, im2col,
                         pcilt_conv2d, build_dwconv_tables,
                         pcilt_depthwise_conv1d)
