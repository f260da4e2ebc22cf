"""Scene model: flat geometry, the material table, the light bank, mesh
providers and the Scene builder (numpy on the host, tensors at the end)."""
