from eig_kl_tpu_torch.utils.config import KLConfig, SpectralConfig

__all__ = ["KLConfig", "SpectralConfig"]
