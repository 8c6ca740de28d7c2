"""repro_torch.bench — the benchmark sections ported so far (§4.5 kernel
sites, ``sections.section_kernels``) and the shared gates the report
renderers read (``schema``)."""
