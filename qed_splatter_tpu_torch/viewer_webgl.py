"""Client-side WebGL2 gaussian-splat renderer for the live viewer (port of
``viewer_webgl.py``; the page is the same string).

The browser renders the splats itself at display rate (orbit, pan and zoom
without a round trip to the server per frame) from the packed 32-byte splat
buffer served at ``/splats`` (``engine.checkpoint.pack_splat_buffer``).
During training the page polls ``/status`` and refetches the buffer as the
model evolves.

The renderer is EWA splatting as WebGL2 instanced quads: per-splat data in
an RGBA32F texture (4 texels per splat: position, scale, quat wxyz, rgba);
the vertex shader projects the 3D covariance (J W Sigma W^T J^T) and emits
a +-3 sigma screen-space quad along the 2D eigenvectors; the fragment
shader applies the gaussian falloff; a JS counting sort keeps the instances
back to front for over-compositing. Camera conventions match the server's
orbit renderer (``testing.orbit_c2w_opengl``: world up +y, OpenGL c2w).
"""

WEBGL_PAGE = r"""<!DOCTYPE html>
<html><head><title>qed-splatter-tpu webgl viewer</title><style>
body { margin:0; background:#0b0b0e; color:#eee; font-family:sans-serif;
       overflow:hidden; }
#hud { position:fixed; top:8px; left:8px; background:#0009; padding:10px;
       border-radius:6px; font-size:13px; max-width:360px; z-index:2; }
#train { color:#8fd; margin-top:4px; }
canvas { display:block; width:100vw; height:100vh; }
a { color:#9cf; }
</style></head><body>
<div id="hud">
  <div>drag: orbit &middot; shift-drag: pan &middot; wheel: zoom
       &middot; <a href="/">server-render view</a></div>
  <div id="s">loading splats…</div>
  <div id="train"></div>
  <div><label><input type="checkbox" id="live" checked/>
       live refresh while training</label></div>
</div>
<canvas id="c"></canvas>
<script>
const canvas = document.getElementById('c');
const gl = canvas.getContext('webgl2', {antialias:false});
const hud = document.getElementById('s');
if (!gl) hud.textContent = 'WebGL2 not available in this browser';

const TW = 4096;  // data-texture width in texels (4 texels per splat)
const VS = `#version 300 es
precision highp float; precision highp int;
layout(location=0) in vec2 corner;
layout(location=1) in uint sid;
uniform sampler2D dataTex;
uniform mat3 viewR;      // world -> cam (x right, y down, z forward)
uniform vec3 viewT;
uniform vec2 focal;
uniform vec2 viewport;
out vec4 vColor;
out vec2 vPos;
vec4 texel(uint i){ int t = int(i); return texelFetch(dataTex, ivec2(t & 4095, t >> 12), 0); }
void main(){
  uint b = sid * 4u;
  vec3 center = texel(b).xyz;
  vec3 scale  = texel(b + 1u).xyz;
  vec4 q      = texel(b + 2u);          // wxyz, normalized
  vec4 col    = texel(b + 3u);
  vec3 cam = viewR * center + viewT;
  if (cam.z < 0.05) { gl_Position = vec4(0.,0.,2.,1.); vColor = vec4(0.); vPos = vec2(0.); return; }
  float w=q.x, x=q.y, y=q.z, z=q.w;
  mat3 R = mat3(
    1.-2.*(y*y+z*z), 2.*(x*y+w*z),    2.*(x*z-w*y),
    2.*(x*y-w*z),    1.-2.*(x*x+z*z), 2.*(y*z+w*x),
    2.*(x*z+w*y),    2.*(y*z-w*x),    1.-2.*(x*x+y*y));
  mat3 M = mat3(R[0]*scale.x, R[1]*scale.y, R[2]*scale.z);
  mat3 cov3 = M * transpose(M);
  float iz = 1.0 / cam.z;
  mat3 J = mat3(focal.x*iz, 0., 0.,
                0., focal.y*iz, 0.,
                -focal.x*cam.x*iz*iz, -focal.y*cam.y*iz*iz, 0.);
  mat3 T = J * viewR;
  mat3 cov2 = T * cov3 * transpose(T);
  float a = cov2[0][0] + 0.3, d = cov2[1][1] + 0.3, bxy = cov2[0][1];
  float mid = 0.5*(a+d);
  float rad = sqrt(max(0.0, mid*mid - (a*d - bxy*bxy)));
  float l1 = max(mid + rad, 1e-4), l2 = max(mid - rad, 1e-4);
  vec2 e1 = (abs(bxy) > 1e-9) ? normalize(vec2(bxy, l1 - a))
                              : ((a >= d) ? vec2(1.,0.) : vec2(0.,1.));
  vec2 e2 = vec2(-e1.y, e1.x);
  vec2 px = corner.x * e1 * 3.0 * sqrt(l1) + corner.y * e2 * 3.0 * sqrt(l2);
  vec2 ndc = vec2(cam.x*focal.x*iz, cam.y*focal.y*iz) * 2.0 / viewport
           + px * 2.0 / viewport;
  gl_Position = vec4(ndc.x, -ndc.y, 0.0, 1.0);
  vColor = col;
  vPos = corner * 3.0;
}`;
const FS = `#version 300 es
precision highp float;
in vec4 vColor; in vec2 vPos; out vec4 frag;
void main(){
  float r2 = dot(vPos, vPos);
  if (r2 > 9.0) discard;
  float a = vColor.a * exp(-0.5 * r2);
  if (a < 0.0039) discard;
  frag = vec4(vColor.rgb, a);
}`;

function shader(type, src){
  const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s;
}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog);
if (!gl.getProgramParameter(prog, gl.LINK_STATUS))
  hud.textContent = 'shader link failed: ' + gl.getProgramInfoLog(prog);
gl.useProgram(prog);
const U = n => gl.getUniformLocation(prog, n);

const quadBuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, quadBuf);
gl.bufferData(gl.ARRAY_BUFFER,
  new Float32Array([-1,-1, 1,-1, -1,1, 1,1]), gl.STATIC_DRAW);
gl.enableVertexAttribArray(0);
gl.vertexAttribPointer(0, 2, gl.FLOAT, false, 0, 0);

const idxBuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, idxBuf);
gl.enableVertexAttribArray(1);
gl.vertexAttribIPointer(1, 1, gl.UNSIGNED_INT, 0, 0);
gl.vertexAttribDivisor(1, 1);

gl.disable(gl.DEPTH_TEST);
gl.enable(gl.BLEND);
gl.blendFunc(gl.SRC_ALPHA, gl.ONE_MINUS_SRC_ALPHA);
const dataTex = gl.createTexture();

let N = 0, positions = null, order = null, depths = null;
let az = 0.0, el = 0.2, r = 3.0, target = [0, 0, 0], dirtySort = true;
let lastSortDir = [0, 0, 0];

fetch('/meta').then(r => r.json()).then(m => {
  if (m.target) target = m.target;
}).catch(()=>{});

async function loadSplats(){
  const resp = await fetch('/splats');
  const step = resp.headers.get('X-Step');
  const buf = await resp.arrayBuffer();
  N = buf.byteLength >> 5;
  const f = new Float32Array(buf), u = new Uint8Array(buf);
  positions = new Float32Array(3 * N);
  depths = new Float32Array(N);
  order = new Uint32Array(N);
  const H = Math.max(1, Math.ceil(4 * N / TW));
  const tex = new Float32Array(TW * H * 4);
  for (let i = 0; i < N; i++){
    const fo = i * 8, uo = i * 32, to = i * 16;
    for (let k = 0; k < 3; k++){
      positions[3*i+k] = f[fo+k];
      tex[to+k] = f[fo+k];
      tex[to+4+k] = f[fo+3+k];
    }
    for (let k = 0; k < 4; k++) tex[to+8+k]  = (u[uo+28+k] - 128) / 128;
    for (let k = 0; k < 4; k++) tex[to+12+k] = u[uo+24+k] / 255;
  }
  gl.activeTexture(gl.TEXTURE0);
  gl.bindTexture(gl.TEXTURE_2D, dataTex);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MIN_FILTER, gl.NEAREST);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MAG_FILTER, gl.NEAREST);
  gl.texImage2D(gl.TEXTURE_2D, 0, gl.RGBA32F, TW, H, 0, gl.RGBA, gl.FLOAT, tex);
  gl.uniform1i(U('dataTex'), 0);
  gl.bindBuffer(gl.ARRAY_BUFFER, idxBuf);
  gl.bufferData(gl.ARRAY_BUFFER, N * 4, gl.DYNAMIC_DRAW);
  dirtySort = true;
  hud.textContent = N.toLocaleString() + ' splats' + (step ? ' @ step ' + step : '');
}

function camBasis(){
  const ce = Math.cos(el), se = Math.sin(el);
  const ca = Math.cos(az), sa = Math.sin(az);
  const eye = [target[0] + r*ce*sa, target[1] + r*se, target[2] - r*ce*ca];
  let fwd = [target[0]-eye[0], target[1]-eye[1], target[2]-eye[2]];
  const fl = Math.hypot(...fwd); fwd = fwd.map(v => v/fl);
  // right = normalize(cross(fwd, worldUp=(0,1,0)))
  let right = [ -fwd[2], 0, fwd[0] ];
  const rl = Math.hypot(...right) || 1; right[0]/=rl; right[2]/=rl;
  // camUp = cross(right, fwd)
  const up = [ right[1]*fwd[2]-right[2]*fwd[1],
               right[2]*fwd[0]-right[0]*fwd[2],
               right[0]*fwd[1]-right[1]*fwd[0] ];
  return {eye, fwd, right, up};
}

function sortSplats(fwd, eye){
  if (!N) return;
  let mn = Infinity, mx = -Infinity;
  for (let i = 0; i < N; i++){
    const d = fwd[0]*(positions[3*i]-eye[0])
            + fwd[1]*(positions[3*i+1]-eye[1])
            + fwd[2]*(positions[3*i+2]-eye[2]);
    depths[i] = d;
    if (d < mn) mn = d; if (d > mx) mx = d;
  }
  const B = 65536, counts = new Uint32Array(B + 1);
  const scale = (B - 1) / Math.max(mx - mn, 1e-9);
  const keys = new Uint32Array(N);
  for (let i = 0; i < N; i++){
    const k = (B - 1) - ((depths[i] - mn) * scale | 0);  // far -> small key
    keys[i] = k; counts[k + 1]++;
  }
  for (let k = 0; k < B; k++) counts[k + 1] += counts[k];
  for (let i = 0; i < N; i++) order[counts[keys[i]]++] = i;
  gl.bindBuffer(gl.ARRAY_BUFFER, idxBuf);
  gl.bufferSubData(gl.ARRAY_BUFFER, 0, order);
  lastSortDir = [fwd[0], fwd[1], fwd[2]];
}

let frames = 0, lastFps = performance.now();
function draw(){
  const W = canvas.clientWidth, H = canvas.clientHeight;
  if (canvas.width !== W || canvas.height !== H){
    canvas.width = W; canvas.height = H;
  }
  gl.viewport(0, 0, W, H);
  gl.clearColor(0.04, 0.04, 0.055, 1.0);
  gl.clear(gl.COLOR_BUFFER_BIT);
  if (N){
    const {eye, fwd, right, up} = camBasis();
    const drift = Math.abs(fwd[0]-lastSortDir[0]) + Math.abs(fwd[1]-lastSortDir[1])
                + Math.abs(fwd[2]-lastSortDir[2]);
    if (dirtySort || drift > 0.08){ sortSplats(fwd, eye); dirtySort = false; }
    // world->cam rows: [right; -up; fwd]  (OpenCV: x right, y down, z fwd)
    const Rm = [right[0], -up[0], fwd[0],
                right[1], -up[1], fwd[1],
                right[2], -up[2], fwd[2]];   // column-major mat3
    const Tv = [-(Rm[0]*eye[0]+Rm[3]*eye[1]+Rm[6]*eye[2]),
                -(Rm[1]*eye[0]+Rm[4]*eye[1]+Rm[7]*eye[2]),
                -(Rm[2]*eye[0]+Rm[5]*eye[1]+Rm[8]*eye[2])];
    gl.uniformMatrix3fv(U('viewR'), false, Rm);
    gl.uniform3fv(U('viewT'), Tv);
    const f = 0.8 * Math.max(W, H);   // matches the server-render focal
    gl.uniform2f(U('focal'), f, f);
    gl.uniform2f(U('viewport'), W, H);
    gl.drawArraysInstanced(gl.TRIANGLE_STRIP, 0, 4, N);
  }
  frames++;
  const now = performance.now();
  if (now - lastFps > 1000){
    if (N) hud.textContent = N.toLocaleString() + ' splats · '
      + (frames * 1000 / (now - lastFps)).toFixed(0) + ' fps';
    frames = 0; lastFps = now;
  }
  requestAnimationFrame(draw);
}

let drag = 0, lx = 0, ly = 0;
canvas.onmousedown = e => { drag = e.shiftKey ? 2 : 1; lx = e.clientX; ly = e.clientY; };
window.onmouseup = () => drag = 0;
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - lx, dy = e.clientY - ly; lx = e.clientX; ly = e.clientY;
  if (drag === 1){
    az += dx * 0.008; el += dy * 0.008;
    el = Math.max(-1.5, Math.min(1.5, el));
  } else {
    const {right, up} = camBasis();
    const s = r * 0.0015;
    for (let k = 0; k < 3; k++) target[k] -= (right[k]*dx - up[k]*dy) * s;
  }
};
window.onwheel = e => { r *= (1 + Math.sign(e.deltaY) * 0.1); r = Math.max(0.1, r); };

let lastStep = -1;
function poll(){
  fetch('/status').then(r => r.json()).then(st => {
    let t = 'step ' + st.step;
    if (st.metrics){
      if (st.metrics.loss !== undefined) t += ' · loss ' + st.metrics.loss.toFixed(4);
      if (st.metrics.psnr !== undefined) t += ' · psnr ' + st.metrics.psnr.toFixed(2);
    }
    if (st.gaussian_count) t += ' · ' + st.gaussian_count.toLocaleString() + ' gaussians';
    if (st.training) t += ' · training';
    document.getElementById('train').textContent = t;
    if (document.getElementById('live').checked && st.step !== lastStep
        && st.ready){
      lastStep = st.step;
      loadSplats().catch(()=>{});
    }
  }).catch(()=>{});
}
setInterval(poll, 2000);
loadSplats().then(()=>{ poll(); draw(); })
  .catch(e => { hud.textContent = 'failed to load splats: ' + e; draw(); });
</script></body></html>"""
