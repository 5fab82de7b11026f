#!/usr/bin/env bash
# Container end-to-end test: build artifact -> ingest the exampleDataset
# BOTH ways (TSV+FASTA and NDJSON) inside the container -> boot --api ->
# replay the 94+13 conformance corpus + protocol assertions over HTTP.
#
# Reference analog: endToEndTests/docker-compose-for-tests-preprocessing-
# from-{tsv,ndjson}.yml driven by the reference CI's endToEndTests matrix.
#
# Usage: SILO_REFERENCE_ROOT=/path/to/reference docker/e2e_test.sh [image]
set -euo pipefail

REF=${SILO_REFERENCE_ROOT:-/root/reference}
IMG=${1:-lapis-silo-tpu}
PORT=${SILO_E2E_PORT:-18081}
DATASET="$REF/testBaseData/exampleDataset"
WORK=$(mktemp -d)
cleanup() {
  docker rm -f silo-e2e >/dev/null 2>&1 || true
  rm -rf "$WORK"
}
trap cleanup EXIT

run_flavor() {
  local flavor=$1 input_dir=$2 ppc=$3
  mkdir -p "$WORK/${flavor}_out"
  echo "=== [$flavor] preprocessing in container ==="
  docker run --rm \
    -v "$input_dir:/preprocessing/input:ro" \
    -v "$ppc:/app/ppc.yaml:ro" \
    -v "$WORK/${flavor}_out:/preprocessing/output" \
    -e JAX_PLATFORMS=cpu \
    "$IMG" --preprocessing --preprocessingConfig /app/ppc.yaml \
    --databaseConfig /preprocessing/input/database_config.yaml

  echo "=== [$flavor] serving + corpus replay over HTTP ==="
  docker rm -f silo-e2e >/dev/null 2>&1 || true
  docker run -d --name silo-e2e -p "$PORT:8081" \
    -v "$WORK/${flavor}_out:/data:ro" \
    -e JAX_PLATFORMS=cpu \
    "$IMG" --api --dataDirectory /data
  SILO_REFERENCE_ROOT="$REF" python scripts/http_conformance.py \
    --url "http://localhost:$PORT" || {
      echo "--- container logs ---"; docker logs silo-e2e | tail -50; exit 1; }
  docker rm -f silo-e2e >/dev/null
}

# flavor 1: TSV + FASTA
cat > "$WORK/ppc_tsv.yaml" <<EOF
inputDirectory: "/preprocessing/input/"
outputDirectory: "/preprocessing/output/"
intermediateResultsDirectory: "/tmp/silo_temp/"
metadataFilename: "small_metadata_set.tsv"
pangoLineageDefinitionFilename: "pangolineage_alias.json"
referenceGenomeFilename: "reference_genomes.json"
EOF
run_flavor tsv "$DATASET" "$WORK/ppc_tsv.yaml"

# flavor 2: NDJSON (generated from the same dataset, as in reference CI)
mkdir -p "$WORK/ndjson_in"
python scripts/make_ndjson_corpus.py "$DATASET" "$WORK/ndjson_in/input_file.ndjson"
cp "$DATASET/reference_genomes.json" "$DATASET/pangolineage_alias.json" \
   "$DATASET/database_config.yaml" "$WORK/ndjson_in/"
cat > "$WORK/ppc_ndjson.yaml" <<EOF
inputDirectory: "/preprocessing/input/"
outputDirectory: "/preprocessing/output/"
intermediateResultsDirectory: "/tmp/silo_temp/"
ndjsonInputFilename: "input_file.ndjson"
pangoLineageDefinitionFilename: "pangolineage_alias.json"
referenceGenomeFilename: "reference_genomes.json"
EOF
run_flavor ndjson "$WORK/ndjson_in" "$WORK/ppc_ndjson.yaml"

# Literal reference JS harness (endToEndTests: supertest + chai + node:test)
# against the shipped image — the Python replay above re-implements every
# assertion (tests/test_js_harness_parity.py maps them 1:1), but only the
# real harness rules out a shared blind spot (supertest header/chunking
# behavior, chai deep-equal edge semantics). Gated on npm: the dev image
# has no node; CI installs it (reference ci.yml endToEndTests job).
if command -v npm >/dev/null 2>&1; then
  echo "=== reference JS e2e harness (npm test) ==="
  docker run -d --name silo-e2e -p "$PORT:8081" \
    -v "$WORK/tsv_out:/data:ro" \
    -e JAX_PLATFORMS=cpu \
    "$IMG" --api --dataDirectory /data
  for _ in $(seq 60); do
    curl -sf "http://localhost:$PORT/info" >/dev/null && break
    sleep 1
  done
  cp -r "$REF/endToEndTests" "$WORK/endToEndTests"
  (cd "$WORK/endToEndTests" && npm ci --no-audit --no-fund \
    && SILO_URL="http://localhost:$PORT" npm test) || {
      echo "--- container logs ---"; docker logs silo-e2e | tail -50; exit 1; }
  docker rm -f silo-e2e >/dev/null
  echo "container e2e: reference JS harness green"
else
  echo "npm not available - skipping the literal JS harness" \
       "(every assertion is replayed by scripts/http_conformance.py above" \
       "and tests/test_js_harness_parity.py)"
fi

echo "container e2e: BOTH ingest flavors corpus-exact over HTTP"
