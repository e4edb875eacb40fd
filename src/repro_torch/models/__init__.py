"""The LM stack of the port: the configuration dataclass, the dense
family's layers and model, with attention on the flash attention kernel."""
