"""Prompt templates per model family (a copy of the JAX package's
``models/templates.py``).

Every family prompts the MLLM to summarize the sentence or image "in one
word", wrapped in its chat format, and reads representations at the
next-token position. The ``<sent>`` slot is substituted, and the ``<image>``
slot expanded to one placeholder token per image embedding, at encode time.

String-wrapper families (Llama-3, LLaVA-1.5) use literal wrappers.
Chat-message families (Qwen2.5-VL, InternVL2.5) are rendered as the
reference renders them, ``apply_chat_template(messages, tokenize=False,
add_generation_prompt=True)``: when a converted checkpoint ships an HF
tokenizer with a chat template, ``resolve_template`` renders through it;
otherwise the wrappers below, which reproduce the known rendered output of
those templates, are used unchanged. On the card there is no
``transformers``, so a checkpoint's tokenizer is None and the wrappers are
what serves.

Image-token expansion is family-specific: the single ``<image>`` slot
becomes ``wrap_open + image_token x n + wrap_close`` (InternVL:
``<img><IMG_CONTEXT>...</img>``; Qwen:
``<|vision_start|><|image_pad|>...<|vision_end|>``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

IMAGE_SLOT = "<image>"
TEXT_SLOT = "<sent>"

_SUMMARY_IMG = "\nSummary above image in one word: "
_SUMMARY_TEXT = "\nSummary above sentence in one word: "
_SUMMARY_IMG_OPEN = "\nSummary above image: "
_SUMMARY_TEXT_OPEN = "\nSummary above sentence: "


@dataclass(frozen=True)
class PromptTemplate:
    """A prompt wrapper with a ``{}`` hole for the user content.

    ``image_token``/``image_wrap``/``image_sep`` control how the single
    ``<image>`` slot expands to the per-image embedding-slot count.
    """

    wrapper: str
    image_token: str = IMAGE_SLOT
    image_wrap: Tuple[str, str] = ("", "")
    image_sep: str = ""

    def image_prompt(self, one_word: bool = True) -> str:
        body = IMAGE_SLOT + (_SUMMARY_IMG if one_word else _SUMMARY_IMG_OPEN)
        return self.wrapper.format(body)

    def text_prompt(self, one_word: bool = True) -> str:
        body = TEXT_SLOT + (_SUMMARY_TEXT if one_word else _SUMMARY_TEXT_OPEN)
        return self.wrapper.format(body)

    def fill_text(self, prompt: str, sentence: str) -> str:
        return prompt.replace(TEXT_SLOT, sentence)

    def expand_image(self, prompt: str, n_tokens: int) -> str:
        """Replace the ``<image>`` slot with n image-placeholder tokens."""
        expanded = (self.image_wrap[0]
                    + self.image_sep.join([self.image_token] * n_tokens)
                    + self.image_wrap[1])
        return prompt.replace(IMAGE_SLOT, expanded, 1)


# Llama-3 chat wrapper (LLaVA-NeXT-Llama3-8B, E5-V), ending with the
# assistant turn open + a space+newline so the next token is the summary word.
LLAMA3 = PromptTemplate(
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
    "<|start_header_id|>assistant<|end_header_id|>\n\n \n")

# Vicuna-ish wrapper used by the reference for LLaVA-1.5 / 1.6-Vicuna
# ("no_special" variant).
LLAVA_V1_5 = PromptTemplate("<s>user\n\n{}</s><s>assistant\n\n \n")

# Qwen2.5-VL: ChatML with the template's implicit default system message.
# Fallback rendering of apply_chat_template(img/text_prompt_qwen_v2_5,
# add_generation_prompt=True).
_QWEN_SYSTEM = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
QWEN2_5_VL = PromptTemplate(
    _QWEN_SYSTEM + "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n",
    image_token="<|image_pad|>",
    image_wrap=("<|vision_start|>", "<|vision_end|>"))

# InternVL2.5: plain ChatML (the shipped tokenizer template adds no implicit
# system turn); image expansion wraps in <img>...</img>.
INTERNVL2_5 = PromptTemplate(
    "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n",
    image_token="<IMG_CONTEXT>",
    image_wrap=("<img>", "</img>"))

# Chat-message structural forms (what the reference feeds
# apply_chat_template); used by resolve_template with a real HF tokenizer.
QWEN2_5_VL_IMAGE_MESSAGES = [{
    "role": "user",
    "content": [
        {"type": "image", "image": "{}"},
        {"type": "text", "text": _SUMMARY_IMG},
    ],
}]
QWEN2_5_VL_TEXT_MESSAGES = [{
    "role": "user",
    "content": [
        {"type": "text", "text": TEXT_SLOT},
        {"type": "text", "text": _SUMMARY_TEXT},
    ],
}]

INTERNVL2_5_IMAGE_MESSAGES = [
    {"role": "user", "content": IMAGE_SLOT + _SUMMARY_IMG}]
INTERNVL2_5_TEXT_MESSAGES = [
    {"role": "user", "content": TEXT_SLOT + _SUMMARY_TEXT}]

_CHAT_MESSAGES = {
    "<|image_pad|>": (QWEN2_5_VL_IMAGE_MESSAGES, QWEN2_5_VL_TEXT_MESSAGES),
    "<IMG_CONTEXT>": (INTERNVL2_5_IMAGE_MESSAGES, INTERNVL2_5_TEXT_MESSAGES),
}

# Self-contained wrapper for the tiny debug family (WordPieceLite tokenizer —
# plain text, no chat specials; tokens need whitespace separation).
TINY = PromptTemplate("user: {}\nassistant: ", image_sep=" ")


def resolve_template(template: PromptTemplate, tokenizer) -> PromptTemplate:
    """Re-render a chat-family template through the checkpoint's own HF chat
    template when one is available — exact parity with the reference's
    ``processor.apply_chat_template`` path. Returns ``template`` unchanged
    for string-wrapper families or when no chat template is shipped.
    """
    messages = _CHAT_MESSAGES.get(template.image_token)
    hf_tok = getattr(tokenizer, "hf_tokenizer", None)
    if messages is None or hf_tok is None or \
            not getattr(hf_tok, "chat_template", None):
        return template
    img_messages, text_messages = messages
    rendered_img = hf_tok.apply_chat_template(
        img_messages, tokenize=False, add_generation_prompt=True)
    rendered_text = hf_tok.apply_chat_template(
        text_messages, tokenize=False, add_generation_prompt=True)
    # Normalize both renders into one wrapper: the image render carries the
    # family's image placeholder where the processor put it; reduce it back
    # to the <image> slot so expand_image controls the count.
    slot = (template.image_wrap[0] + template.image_token
            + template.image_wrap[1])
    if slot in rendered_img:
        rendered_img = rendered_img.replace(slot, IMAGE_SLOT, 1)
    elif template.image_token in rendered_img:
        rendered_img = rendered_img.replace(template.image_token,
                                            IMAGE_SLOT, 1)
    return _ResolvedTemplate(
        wrapper="{}",  # unused; prompts are fully rendered
        image_token=template.image_token,
        image_wrap=template.image_wrap,
        image_sep=template.image_sep,
        rendered_image=rendered_img,
        rendered_text=rendered_text,
    )


@dataclass(frozen=True)
class _ResolvedTemplate(PromptTemplate):
    """Template whose prompts were rendered by a real HF chat template.

    The messages fed to apply_chat_template carry the one-word summary
    instruction (the reference only ever uses that form for chat families);
    ``one_word=False`` derives the open variant by dropping the
    " in one word" clause from the rendered string."""

    rendered_image: str = ""
    rendered_text: str = ""

    @staticmethod
    def _variant(rendered: str, one_word: bool) -> str:
        return rendered if one_word else rendered.replace(" in one word:", ":")

    def image_prompt(self, one_word: bool = True) -> str:
        return self._variant(self.rendered_image, one_word)

    def text_prompt(self, one_word: bool = True) -> str:
        return self._variant(self.rendered_text, one_word)
