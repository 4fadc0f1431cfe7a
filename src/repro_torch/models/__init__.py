from repro_torch.models.model import Model, build_model, padded_vocab  # noqa: F401
