"""repro_torch.core — PCILT quantization, offsets, table builds (sharded
over a mesh too), layers with their tensor-parallel routes, learnable
tables, and the converted Mamba decode (under a sharding context,
``PCILTMambaDecode(ctx=)``)."""

from .quantization import (QuantSpec, scale_from_amax, calibrate, quantize,
                           quantize_with_stats, dequantize, fake_quant,
                           code_values)
from .offsets import pack_offsets, unpack_offsets, offset_grid, SegmentPlan
from .pcilt import (mul_fn, log_mul_fn, build_scalar_tables, table_bytes,
                    grouped_table_bytes, shared_table_bytes,
                    shared_pool_bytes, build_cost_multiplies,
                    build_grouped_tables, build_paired_tables,
                    build_paired_stacked_tables, SharedTables,
                    build_shared_tables, SharedGroupedTables,
                    build_shared_grouped_tables, ShardedTables,
                    ShardedSharedPool, shard_shared_grouped_tables,
                    table_checksum, layer_checksum, stacked_checksums,
                    checksums)
from .lut_layers import (conv_same_pads, lut_lookup, pcilt_linear, im2col,
                         pcilt_conv2d, build_dwconv_tables,
                         pcilt_depthwise_conv1d, mesh_shard_count)
from .learnable import (init_learnable_pcilt, apply_learnable_pcilt,
                        effective_tables, extract_filters)
