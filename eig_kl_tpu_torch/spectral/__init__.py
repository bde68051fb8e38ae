from eig_kl_tpu_torch.spectral.power import power_partition_fiedler
from eig_kl_tpu_torch.spectral.partition import median_split, eig_partition

__all__ = ["power_partition_fiedler", "median_split", "eig_partition"]
