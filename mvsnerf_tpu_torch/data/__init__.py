"""The port's datasets by `--dataset_name` (counterpart of
mvsnerf_tpu/data/__init__.py:9-14): `dtu` (generalizable training),
`dtu_ft`, `blender` and `llff` (per-scene fine-tuning, evaluation and
video)."""

from .blender import BlenderDataset
from .dtu import MVSDatasetDTU
from .dtu_ft import DTUFTDataset
from .llff import LLFFDataset

dataset_dict = {
    "dtu": MVSDatasetDTU,
    "llff": LLFFDataset,
    "blender": BlenderDataset,
    "dtu_ft": DTUFTDataset,
}

# the datasets of one scene, which the fine-tune, eval and video CLIs take
PER_SCENE = ("dtu_ft", "blender", "llff")


def per_scene_dataset(name: str):
    """The dataset class of a per-scene `--dataset_name`; `dtu` (the
    generalizable trainer's multi-scan dataset) raises."""
    if name not in PER_SCENE:
        raise ValueError(f"--dataset_name {name}: a per-scene dataset is "
                         f"needed, one of {list(PER_SCENE)} ({name} is the "
                         "generalizable trainer's, train_mvs_nerf)")
    return dataset_dict[name]
