from robot_mpcs_tpu_torch.perception.free_space_decomposition import (
    FreeSpaceDecomposition,
    HalfPlane,
    free_space_halfplanes,
)
