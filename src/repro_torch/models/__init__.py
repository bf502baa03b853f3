"""Language-model stack of the port (dense and SSM families): configuration,
layers, Mamba2, blocks and the LM entry points."""
