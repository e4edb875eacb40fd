"""Serving: the continuous-batching engine, the SiM-paged KV cache and the
prefill/decode serving steps."""
