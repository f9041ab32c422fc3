"""A tiny configuration and cells for the CPU tests: the shapes of VAR and
its VQVAE at a size a test run holds (the port runs its plain paths on
the CPU)."""

import copy

PATCH_NUMS = [1, 2, 4, 8]

MODEL = {
    "name": "tiny",
    "var": {"depth": 2, "embed_dim": 64, "num_heads": 2, "head_dim": 32,
            "mlp_ratio": 4.0, "mlp_hidden": 256, "patch_nums": PATCH_NUMS,
            "L": sum(p * p for p in PATCH_NUMS), "vocab_size": 64, "Cvae": 8,
            "num_classes": 10, "norm_eps": 1e-6, "shared_aln": False,
            "attn_l2_norm": True, "cond_drop_rate": 0.1, "drop_rate": 0.0,
            "drop_path_rate": 0.1},
    "vqvae": {"vocab_size": 64, "z_channels": 8, "ch": 32, "ch_mult": [1, 2],
              "num_res_blocks": 1, "quant_resi": 0.5, "share_quant_resi": 4,
              "using_sa": True, "using_mid_sa": True, "quant_conv_ks": 3,
              "beta": 0.25},
    "dtype": "bfloat16",
    "sampling": {"cfg": 1.5, "top_k": 20, "top_p": 0.96},
    "train": {"global_batch_size": 4, "peak_lr": 1e-3, "weight_decay": 0.05,
              "grad_clip": 2.0, "label_smooth": 0.1},
}

FID = {"name": "tiny.fid", "config": "tiny", "driver": "fid", "chips": 1,
       "why": "test", "model": MODEL,
       "traffic": {"batch": 4, "schedule": 64, "per_class": 3, "kv": "bf16",
                   "quant": "none", "pixels": "f32", "warmup_batches": 1,
                   "trace_batches": 2, "check_images": 4,
                   "check_batches": 2},
       "limits": {"logit_err": 0.2, "sample_gap": 1e-3, "pixel_err": 1e-4}}


def cell(base, **traffic):
    c = copy.deepcopy(base)
    c["traffic"].update(traffic)
    return c

TRAIN = {"name": "tiny.train", "config": "tiny", "driver": "train",
         "chips": 1, "why": "test", "model": MODEL,
         "traffic": {"pool_images": 16, "reso": 16, "trace_steps": 2},
         "limits": {"loss_err": 0.01, "grad_err": 0.003, "update_err": 0.005}}

SERVE = {"name": "tiny.serve", "config": "tiny", "driver": "serve",
         "chips": 1, "why": "test", "model": MODEL,
         "traffic": {"rate": 100.0, "buckets": [2, 4], "max_batch": 4,
                     "max_wait_ms": 5.0, "kv": "bf16", "deliver": "u8",
                     "drain_s": 30.0, "trace_seconds": 0.5,
                     "check_images": 4, "check_batches": 2},
         "limits": {"logit_err": 0.2, "sample_gap": 1e-3, "pixel_mae": 0.01}}

FID_W8A8 = cell(FID, quant="w8a8", kv="int8")
FID_W8A8["name"] = "tiny.fid-w8a8"
FID_W8A8["limits"] = {"logit_err": 0.6, "sample_gap": 1e-3, "pixel_err": 1e-4}
