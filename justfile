# Workflow recipes (the reference uses a justfile the same way).

# Run the full test suite on a virtual 8-device CPU mesh.
test:
    python -m pytest tests/ -q

# Quick smoke: kernels + engine only.
test-fast:
    python -m pytest tests/test_kernels_color.py tests/test_engine.py -q

# North-star benchmark on the GPU (prints one JSON line).
bench:
    python bench.py

# Smoke test on the GPU: session, ladder and 2048px paths at real size,
# parity against the CPU float32 reference, oracle fixture on the device
# path.  Run before any bench or kernel-change commit (CONTRIBUTING.md).
smoke:
    python chip_smoke.py

# Single-chip compile check + 8-device CPU dry run.
graft:
    python __graft_entry__.py

# Re-fit Butteraugli constants against the libjxl golden oracle.
calibrate-butteraugli:
    python tools/calibrate_butteraugli.py

# Verify DSSIM behavioral contract (scale anchors, monotonicity, BA slope).
dssim-check:
    python tools/dssim_check.py

# Regenerate the public API snapshot (CI: just apidoc-check).
apidoc:
    python tools/gen_api_doc.py

apidoc-check:
    python tools/gen_api_doc.py --check

# Build the native host library.
native:
    make -C native

# Stage times and kernel A/Bs on the GPU.
stage-times:
    python tools/gpu_stage_times.py
