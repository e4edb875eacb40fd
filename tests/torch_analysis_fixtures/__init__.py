# Known-good / known-bad fixture modules in the port's idiom for the
# repro_torch.analysis contract linter (tests/test_torch_analysis_contracts.py).
# Each *_tp.py module carries deliberate violations; each *_tn.py is the
# compliant twin.  The `# analysis: pretend-path=` pragma re-homes a fixture
# under src/repro_torch/ so path-scoped rules treat it as an in-scope file.
# The rules whose JAX fixtures (tests/analysis_fixtures/) are idiom-neutral
# lint re-rooted copies of those instead.  These modules are PARSED, never
# imported.
