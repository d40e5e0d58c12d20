"""The port's measurement harnesses: the serve-path load generator
(``serve_bench``) and the engine probe (``kv_microbench``); the
orchestrator that runs them is ``skypilot_tpu_torch.bench``."""
