from layout2img_tpu_torch.eval.inception import InceptionV3, load_torch_inception_v3
from layout2img_tpu_torch.eval.lpips import LPIPS
from layout2img_tpu_torch.eval.metrics import fid_from_features, frechet_distance, inception_score

__all__ = [
    "InceptionV3",
    "load_torch_inception_v3",
    "inception_score",
    "frechet_distance",
    "fid_from_features",
    "LPIPS",
]
