"""EuRoC MAV dataset loader.

Parity surface: /root/reference/tadataka/dataset/euroc.py — stereo cam0/cam1
with sensor.yaml intrinsics + T_BS extrinsics, body-frame ground truth
synced to both image streams.
"""

from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation

from tadataka_tpu.camera import CameraModel, CameraParameters, RadTan
from tadataka_tpu.core.pose import Pose
from tadataka_tpu.dataset.base import BaseDataset
from tadataka_tpu.dataset.frame import Frame
from tadataka_tpu.dataset.tum import load_image_paths, synchronize


def _camera_dir(dataset_root, camera_index):
    return Path(dataset_root, "cam" + str(camera_index))


def _load_image_paths(dataset_root, camera_index):
    d = _camera_dir(dataset_root, camera_index)
    return load_image_paths(Path(d, "data.csv"), Path(d, "data"),
                            delimiter=',')


def load_camera_params(dataset_root, camera_index):
    import yaml   # only the EuRoC file loader needs it
    path = Path(_camera_dir(dataset_root, camera_index), "sensor.yaml")
    with open(path, 'r') as f:
        d = yaml.safe_load(f)
    intrinsics = np.array(d['intrinsics'])
    dist_coeffs = np.array(d['distortion_coefficients'])
    T_bs = np.array(d['T_BS']['data']).reshape(4, 4)
    return intrinsics, dist_coeffs, T_bs


def _wxyz_to_xyzw(wxyz):
    return wxyz[:, [1, 2, 3, 0]]


def load_body_poses(dataset_root):
    path = Path(dataset_root, "state_groundtruth_estimate0", "data.csv")
    array = np.loadtxt(path, delimiter=',')
    timestamps = array[:, 0]
    positions = array[:, 1:4]
    rotations = Rotation.from_quat(_wxyz_to_xyzw(array[:, 4:8]))
    return timestamps, rotations, positions


def _imread(path):
    from tadataka_tpu.dataset.image_io import imread
    return imread(path)


class EurocDataset(BaseDataset):
    def __init__(self, dataset_root):
        intrinsics0, dist0, self.T_bc0 = load_camera_params(dataset_root, 0)
        intrinsics1, dist1, self.T_bc1 = load_camera_params(dataset_root, 1)

        self.camera_model0 = CameraModel.create(
            CameraParameters.create(intrinsics0[0:2], intrinsics0[2:4]),
            RadTan.create(dist0))
        self.camera_model1 = CameraModel.create(
            CameraParameters.create(intrinsics1[0:2], intrinsics1[2:4]),
            RadTan.create(dist1))

        timestamps0, image_paths0 = _load_image_paths(dataset_root, 0)
        timestamps1, image_paths1 = _load_image_paths(dataset_root, 1)
        timestamps_body, rotations_wb, t_wb = load_body_poses(dataset_root)

        matches = synchronize(timestamps_body, timestamps0,
                              timestamps_ref=timestamps1)
        indices_wb, indices0, indices1 = (matches[:, 0], matches[:, 1],
                                          matches[:, 2])
        self.rotations_wb = rotations_wb[indices_wb]
        self.t_wb = t_wb[indices_wb]
        self.image_paths0 = [image_paths0[i] for i in indices0]
        self.image_paths1 = [image_paths1[i] for i in indices1]
        self.length = matches.shape[0]

    def load(self, index):
        T_wb = np.eye(4)
        T_wb[:3, :3] = self.rotations_wb[index].as_matrix()
        T_wb[:3, 3] = self.t_wb[index]
        T_wc0 = T_wb @ self.T_bc0
        T_wc1 = T_wb @ self.T_bc1

        pose_wc0 = Pose(np.asarray(T_wc0[:3, :3], dtype=np.float32),
                        np.asarray(T_wc0[:3, 3], dtype=np.float32))
        pose_wc1 = Pose(np.asarray(T_wc1[:3, :3], dtype=np.float32),
                        np.asarray(T_wc1[:3, 3], dtype=np.float32))

        I0 = _imread(self.image_paths0[index])
        I1 = _imread(self.image_paths1[index])
        return (Frame(self.camera_model0, pose_wc0, I0, None),
                Frame(self.camera_model1, pose_wc1, I1, None))
