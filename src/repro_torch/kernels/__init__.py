"""Hand-written CUDA kernels of the main path and their plain versions.

    bitonic_sort.py     K1: sort-in-chunks (csrc/bitonic_sort.cu)
    flims_merge.py      K2: partitioned FLiMS 2-way merge (csrc/flims_merge.cu)
    segmented_merge.py  K3: ragged run-pair merge, one launch (same kernel);
                        K5/K6: fused segment sort (csrc/segment_sort.cu),
                        and the two-phase segment sorts over K1 + K3/K4
    merge_tree.py       K4: fused multi-level merge tree (csrc/merge_tree.cu)
    route_fuse.py       K7: fused MoE routing (csrc/route_fuse.cu)
    lane_merge.py       K9: the FLiMS lane merge of a tree level's run
                        pairs, the tree_vmapped executor (csrc/lane_merge.cu)
    stream_merge.py     K8: streaming k-way merge of uniform runs, the
                        out-of-core sort's phase 2 (csrc/stream_merge.cu)
                        (K2 / K3, K4, K8 and K9 past their fast kernels'
                        w, levels and fan-in: csrc/wide_merge.cu)
    ops.py              kernel_sort / kernel_argsort / merge / sort_rows
    ref.py              torch oracles

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version for a CPU tensor; its ``*_plain`` twin runs the plain version on any
device. Keys of any dtype of at most 32 bits go through both widened to
int32 / float32 and narrowed back (``_build.widen`` / ``narrow``).
``launch_counts()`` reads the launches per wrapper.
"""
from repro_torch.kernels._build import (KernelError, launch_counts,
                                        reset_launches)

__all__ = ["KernelError", "launch_counts", "reset_launches"]
