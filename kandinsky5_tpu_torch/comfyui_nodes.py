"""ComfyUI nodes: the pipeline's stages as graph nodes.

Counterpart of ``kandinsky5_tpu/comfyui_nodes.py``, with the same node
names and inputs: load the text embedders, the DiT and the VAE; encode a
caption; expand a prompt; generate latents; decode them to frames. Each
node is also a plain Python class, usable without a ComfyUI host, which
this module does not import.

The loaders build on the CUDA card; each ``load`` also takes ``device``
(and the DiT's ``dit_params`` and ``dtype``) as keyword arguments, which
ComfyUI never passes and a Python caller may.
"""

from __future__ import annotations

import torch

CATEGORY = "Kandinsky5-CUDA"


class Kandinsky5LoadTextEmbedders:
    """Load the Qwen2.5-VL and CLIP text encoders."""

    RETURN_TYPES = ("K5_TEXT_EMBEDDER",)
    FUNCTION = "load"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "qwen_path": ("STRING", {"default": "./weights/text_encoder/"}),
            "clip_path": ("STRING", {"default": "./weights/text_encoder2/"}),
        }}

    def load(self, qwen_path, clip_path, device=None, dtype=torch.bfloat16):
        from kandinsky5_tpu_torch.config import (
            TextEmbedderConfig,
            TextEncoderConfig,
        )
        from kandinsky5_tpu_torch.text.embedder import Kandinsky5TextEmbedder

        conf = TextEmbedderConfig(
            qwen=TextEncoderConfig(checkpoint_path=qwen_path, emb_size=3584,
                                   max_length=256),
            clip=TextEncoderConfig(checkpoint_path=clip_path, emb_size=768,
                                   max_length=77),
        )
        return (Kandinsky5TextEmbedder.from_pretrained(conf, dtype=dtype,
                                                       device=device),)


class Kandinsky5LoadDiT:
    """Load a DiT checkpoint."""

    RETURN_TYPES = ("K5_DIT",)
    FUNCTION = "load"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "checkpoint_path": ("STRING", {"default":
                "./weights/model/kandinsky5lite_t2v_sft_5s.safetensors"}),
            "attention_type": (["flash", "nabla"],),
        }}

    def load(self, checkpoint_path, attention_type="flash", dit_params=None,
             device=None, dtype=torch.bfloat16):
        from kandinsky5_tpu_torch.checkpoint import (
            dit_from_state_dict,
            load_state_dict_file,
        )
        from kandinsky5_tpu_torch.config import DiTParams
        from kandinsky5_tpu_torch.models.dit import DiffusionTransformer3D
        from kandinsky5_tpu_torch.utils import default_device

        cfg = dit_params or DiTParams()
        with torch.device("meta"):
            model = DiffusionTransformer3D(cfg, dtype=dtype)
        model = model.to_empty(device=default_device(device))
        dit_from_state_dict(model, load_state_dict_file(checkpoint_path))
        return ({"model": model, "cfg": cfg,
                 "attention_type": attention_type},)


class Kandinsky5LoadVAE:
    """Load the HunyuanVideo VAE decoder."""

    RETURN_TYPES = ("K5_VAE",)
    FUNCTION = "load"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "vae_path": ("STRING", {"default": "./weights/vae/"}),
        }}

    def load(self, vae_path, device=None, dtype=torch.bfloat16):
        from kandinsky5_tpu_torch.checkpoint import (
            load_vae_state_dict,
            vae_params_from_state_dict,
        )
        from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE

        params = vae_params_from_state_dict(load_vae_state_dict(vae_path),
                                            device=device, dtype=dtype)
        return (HunyuanVideoVAE(params, dtype=dtype),)


class Kandinsky5TextEncode:
    """Encode a caption into the conditioning embeddings."""

    RETURN_TYPES = ("K5_COND",)
    FUNCTION = "encode"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "text_embedder": ("K5_TEXT_EMBEDDER",),
            "prompt": ("STRING", {"multiline": True}),
            "type_of_content": (["video", "image"],),
        }}

    def encode(self, text_embedder, prompt, type_of_content="video"):
        emb = text_embedder.encode([prompt], type_of_content)
        return ({"text_embeds": emb.text_embeds,
                 "pooled_embed": emb.pooled_embed, "mask": emb.mask.bool()},)


class Kandinsky5PromptExpand:
    """Rewrite a prompt with Qwen's expansion."""

    RETURN_TYPES = ("STRING",)
    FUNCTION = "expand"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "text_embedder": ("K5_TEXT_EMBEDDER",),
            "prompt": ("STRING", {"multiline": True}),
        }}

    def expand(self, text_embedder, prompt):
        return (text_embedder.expand_prompt(prompt),)


class Kandinsky5Generate:
    """Run the flow-matching denoise from seeded noise."""

    RETURN_TYPES = ("K5_LATENT",)
    FUNCTION = "generate"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "dit": ("K5_DIT",),
            "cond": ("K5_COND",),
            "negative_cond": ("K5_COND",),
            "width": ("INT", {"default": 768}),
            "height": ("INT", {"default": 512}),
            "length": ("INT", {"default": 121, "tooltip": "video frames"}),
            "steps": ("INT", {"default": 50}),
            "guidance_weight": ("FLOAT", {"default": 5.0}),
            "scheduler_scale": ("FLOAT", {"default": 10.0}),
            "seed": ("INT", {"default": 6554}),
        }}

    def generate(self, dit, cond, negative_cond, width, height, length,
                 steps, guidance_weight, scheduler_scale, seed):
        from kandinsky5_tpu_torch.sampling import DenoiseSpec, generate_latents

        model = dit["model"]
        device = next(model.parameters()).device
        # pixels -> latents: 4x in time (plus the first frame), 8x in space
        num_latent_frames = (length - 1) // 4 + 1
        shape = (1, num_latent_frames, height // 8, width // 8, 16)
        spec = DenoiseSpec(
            dit_params=dit["cfg"], num_steps=steps,
            guidance_weight=guidance_weight, scheduler_scale=scheduler_scale,
            scale_factor=(1.0, 2.0, 2.0),
            attention_type=dit.get("attention_type", "flash"),
        )

        def on_device(c):
            return {k: v.to(device) for k, v in c.items()}

        latents = generate_latents(model, spec, shape, on_device(cond),
                                   on_device(negative_cond), seed=seed)
        return (latents,)


class Kandinsky5VAEDecode:
    """Decode latents to frames in [0, 1], as ComfyUI's IMAGE expects."""

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "decode"
    CATEGORY = CATEGORY

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "vae": ("K5_VAE",),
            "latent": ("K5_LATENT",),
        }}

    @torch.no_grad()
    def decode(self, vae, latent):
        z = latent / vae.scaling_factor
        video = vae.decode(z, mode="stream")
        video = video.float().clamp(-1.0, 1.0)
        frames = ((video + 1.0) / 2.0).cpu()
        return (frames[0],)


NODE_CLASS_MAPPINGS = {
    "Kandinsky5LoadTextEmbedders": Kandinsky5LoadTextEmbedders,
    "Kandinsky5LoadDiT": Kandinsky5LoadDiT,
    "Kandinsky5LoadVAE": Kandinsky5LoadVAE,
    "Kandinsky5TextEncode": Kandinsky5TextEncode,
    "Kandinsky5PromptExpand": Kandinsky5PromptExpand,
    "Kandinsky5Generate": Kandinsky5Generate,
    "Kandinsky5VAEDecode": Kandinsky5VAEDecode,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    name: name.replace("Kandinsky5", "Kandinsky5 CUDA ")
    for name in NODE_CLASS_MAPPINGS
}
