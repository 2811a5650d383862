"""The plain float32 reference of the benchmark's cells.

Plain PyTorch written from the published DUSt3R / MASt3R description
(croco's RoPE100 blocks, dust3r's linear and DPT heads) and from the port's
documented input contract. It imports nothing of `thermal3d_torch`, `jax` or
`thermal3d`, and receives from the benchmark only the seeded weights and the
inputs the benchmark hands the program; everything else (resize matrices,
percentiles, RoPE angles, geometry) it works out itself.
"""
