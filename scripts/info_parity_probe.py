"""Calibrate the Roaring size model against the reference's pinned /info
numbers (endToEndTests/test/info.test.js)."""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


from lapis_silo_tpu.config.database_config import get_validated_config
from lapis_silo_tpu.preprocessing.preprocessing_config import read_preprocessing_config
from lapis_silo_tpu.preprocessing.preprocessor import Preprocessor
from lapis_silo_tpu.storage import roaring_stats

base = "/root/reference/testBaseData/exampleDataset/"
dbconf = get_validated_config(base + "database_config.yaml")
pcfg = read_preprocessing_config(base + "preprocessing_config.yaml")
pcfg.input_directory = base
db = Preprocessor(pcfg, dbconf).preprocess()

print(f"partitions: {len(db.partitions)}")

total_nonportable = 0
n_bitmaps_size = 0
main_per_symbol = None
main_census = {}
main_frozen = main_portable = 0

for part in db.partitions:
    for name, seg in part.nuc_sequences.items():
        st = roaring_stats.segment_stats(seg)
        total_nonportable += st.total_nonportable
        n_bitmaps_size += st.missing_nonportable_total
        if name == "main":
            if main_per_symbol is None:
                main_per_symbol = st.per_symbol_portable.copy()
            else:
                main_per_symbol += st.per_symbol_portable
            for k, v in st.census.items():
                main_census[k] = main_census.get(k, 0) + v
            main_frozen += st.frozen_total
            main_portable += st.portable_total

print(f"totalSize: {total_nonportable}  (expect 26335659)")
print(f"nBitmapsSize: {n_bitmaps_size}  (expect 3898)")

expected_per_symbol = {
    "-": 2648220, "A": 2635348, "B": 2631464, "C": 2634362, "D": 2631464,
    "G": 2633570, "H": 2631464, "K": 2631594, "M": 2631554, "N": 2631464,
    "R": 2631514, "S": 2631464, "T": 2638765, "V": 2631464, "W": 2631514,
    "Y": 2631494,
}
alphabet = next(iter(db.partitions[0].nuc_sequences.values())).alphabet
ok = True
for i, ch in enumerate(alphabet.chars):
    got = int(main_per_symbol[i])
    exp = expected_per_symbol[ch]
    mark = "OK " if got == exp else "BAD"
    if got != exp:
        ok = False
    print(f"  {mark} {ch}: {got} vs {exp} (delta {got - exp})")

expected_census = {
    "numberOfArrayContainers": 3065,
    "numberOfBitsetContainers": 0,
    "numberOfRunContainers": 3,
    "numberOfValuesStoredInArrayContainers": 4377,
    "numberOfValuesStoredInBitsetContainers": 0,
    "numberOfValuesStoredInRunContainers": 9,
    "totalBitmapSizeArrayContainers": 8754,
    "totalBitmapSizeBitsetContainers": 0,
    "totalBitmapSizeRunContainers": 18,
}
for k, exp in expected_census.items():
    got = main_census.get(k, 0)
    mark = "OK " if got == exp else "BAD"
    print(f"  {mark} {k}: {got} vs {exp}")

print(f"main frozen total: {main_frozen}, portable total: {main_portable}")
print("ALL OK" if ok else "MISMATCH")
