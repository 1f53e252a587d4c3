"""Host-side data pipeline (numpy): NIfTI I/O, decathlon datalists, the
reference's MONAI transform chains, the cached dataset and train loader."""
from .dataset import CachedDataset, ShardSampler, TrainLoader
from .datalist import load_decathlon_datalist
from .nifti import load_nifti, save_nifti
from .transforms import invert_to_native, preprocess_case
