"""DatabasePartition: the shard unit.

Parity with reference src/silo/storage/database_partition.cpp — one
partition holds row-aligned typed columns, per-segment bitplane indexes, and
its sequence count. Partitions are the data-parallel axis: on a multi-host deployment
each host/device holds a subset of partitions and queries broadcast.
"""

from __future__ import annotations


from ..ops import bitset
from .segment import SegmentIndex


class DatabasePartition:
    def __init__(self, partition_id: int, sequence_count: int):
        self.partition_id = partition_id
        self.sequence_count = sequence_count
        self.n_words = bitset.words_for(sequence_count)
        self.columns: dict[str, object] = {}  # name -> column partition
        self.nuc_sequences: dict[str, SegmentIndex] = {}
        self.aa_sequences: dict[str, SegmentIndex] = {}
        # Host copies of full/empty masks for this partition's row range.
        self.full = bitset.full_mask(sequence_count)

    def validate(self):
        for name, seg in {**self.nuc_sequences, **self.aa_sequences}.items():
            if seg.n_rows != self.sequence_count:
                raise ValueError(
                    f"Segment {name} row count {seg.n_rows} != partition "
                    f"sequence count {self.sequence_count}"
                )
        for name, col in self.columns.items():
            n = len(col.ids) if getattr(col, "ids", None) is not None else len(col.values)
            if n != self.sequence_count:
                raise ValueError(
                    f"Column {name} row count {n} != partition sequence count "
                    f"{self.sequence_count}"
                )
