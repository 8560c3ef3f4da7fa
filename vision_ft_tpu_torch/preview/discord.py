"""Discord webhook preview callback (``vision_ft_tpu/preview/discord.py``
counterpart): a multipart POST of the preview images as webp files and a
formatted message. The request is built with the standard library
(``urllib.request``); a reply outside 2xx raises, as ``raise_for_status``
does."""

from __future__ import annotations

import urllib.request
import uuid
from io import BytesIO
from typing import Literal, Optional, Union

from PIL import Image
from pydantic import BaseModel, SecretStr

from .util import PreviewCallback


class DiscordWebhookPreviewCallbackConfig(BaseModel):
    type: Literal["discord"] = "discord"
    url: SecretStr

    username: Optional[str] = None
    avatar_url: Optional[str] = None

    message_template: str = """\
- Epoch: `{epoch}`
- Steps: `{steps}`
- Preview ID: `{id}`"""


def encode_multipart(fields: dict, files: dict) -> tuple[bytes, str]:
    """(body, content type) of a multipart/form-data request: ``fields``
    as form values, ``files`` as {field: (file name, file object, content
    type)}, the form ``requests.post(data=fields, files=files)`` sends."""
    boundary = uuid.uuid4().hex
    parts = []
    for name, value in fields.items():
        parts.append(
            f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"\r\n\r\n'
            f"{value}\r\n".encode()
        )
    for name, (file_name, file, content_type) in files.items():
        parts.append(
            f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
            f'filename="{file_name}"\r\nContent-Type: {content_type}\r\n\r\n'.encode()
            + file.read() + b"\r\n"
        )
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


class DiscordWebhookPreviewCallback(PreviewCallback):
    def __init__(self, config: DiscordWebhookPreviewCallbackConfig) -> None:
        self.url = config.url.get_secret_value()
        self.message_template = config.message_template
        self.username = config.username
        self.avatar_url = config.avatar_url
        self.sanity_check()

    @classmethod
    def from_config(cls, config: DiscordWebhookPreviewCallbackConfig, **kwargs):
        return cls(config, **kwargs)

    def format_message(self, epoch: int, steps: int, id: Union[str, int]) -> str:
        return self.message_template.format(epoch=epoch, steps=steps, id=id)

    def compose_body(
        self,
        epoch: int,
        steps: int,
        id: Union[str, int],
        caption: Optional[str] = None,
    ) -> dict:
        message = self.format_message(epoch, steps, id)
        if caption is not None:
            message += f"\n- Caption: \n```\n{caption}\n```"
        body = {"content": message}
        if self.username is not None:
            body["username"] = self.username
        return body

    def prepare_files(self, images: list[Image.Image]) -> dict:
        files = {}
        for i, image in enumerate(images):
            file = BytesIO()
            image.save(file, format="webp")
            file.seek(0)
            files[f"file{i}"] = (f"preview_{i}.webp", file, "image/webp")
        return files

    @staticmethod
    def get_caption(metadata: dict) -> Optional[str]:
        if "caption" in metadata:
            return metadata["caption"]
        if "prompt" in metadata:
            return metadata["prompt"]
        return None

    def preview_image(
        self,
        images: list[Image.Image],
        epoch: int,
        steps: int,
        id: Union[str, int],
        metadata: Optional[dict] = None,
    ):
        metadata = metadata or {}
        body = self.compose_body(epoch, steps, id, caption=self.get_caption(metadata))
        data, content_type = encode_multipart(body, self.prepare_files(images))
        request = urllib.request.Request(
            self.url, data=data, method="POST", headers={"Content-Type": content_type}
        )
        # urlopen raises HTTPError on a reply of 400 or more; 3xx are followed
        with urllib.request.urlopen(request) as response:
            if not 200 <= response.status < 300:
                raise OSError(f"the webhook replied {response.status} {response.reason}")
