"""Model layers of the port: norms, rotary embeddings, embedding, MLP and
attention (each the counterpart of a reference ``repro.layers`` module)."""
