"""The port's train CLI on the reference's weights and batches, in float32:
one rank of ``tests/test_torch_train_mesh.py``'s cross-framework run,
started by ``torchrun``.  Imports torch and the port only.

  torch_train_mesh_rank.py <ref dir> <train CLI arguments...>

``<ref dir>/init`` holds the reference's seed-0 params (its checkpoint
format) and ``<ref dir>/tokens.npy`` its corpus's batches, one a step.
The CLI's ``init_params`` and ``SyntheticCorpus`` are replaced by those,
and the models compute in float32; the CLI itself is unchanged.
"""

import os
import sys

import numpy as np
import torch

import repro_torch.launch.train as T
import repro_torch.models.layers as TL
import repro_torch.models.model as TM
from repro_torch.distributed import checkpoint as C


def main(ref, argv):
    TL.COMPUTE_DTYPE = TM.COMPUTE_DTYPE = torch.float32
    tokens = np.load(os.path.join(ref, "tokens.npy"))

    class Corpus:
        def __init__(self, dc):
            self.dc = dc

        def batch(self, step):
            return {"tokens": torch.from_numpy(tokens[step].copy())}

        def cursor(self, step):
            return {"kind": "reference-batches", "step": step}

    def init_params(cfg, generator=None, device=None):
        like = TM.init_params(cfg, device="meta")
        return C.restore(os.path.join(ref, "init"), like, device=device)[0]

    T.SyntheticCorpus, T.init_params = Corpus, init_params
    return T.main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2:]))
