"""Language-model stack of the port (every family of the model zoo: dense,
MoE, SSM, hybrid, VLM and encoder-decoder): configuration, layers, Mamba2,
MoE, blocks and the LM entry points."""
