"""The analysis plane — so far ``diagnostics`` (the op-site format the
executor's errors cite). The verifier, lints, dataflow and shape
inference of ``paddle_tpu/analysis`` wait for ROADMAP A.6b."""
