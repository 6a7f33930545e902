"""Algorithm 1 on one instance: instances, flows, marginals, the GP step and
the chunked solve driver."""
